"""One process-wide logger for the port, with optional per-run file handlers."""

import logging
import os
import sys
import threading

_LOGGER_NAME = "dls_torch"
_lock = threading.Lock()
_file_handlers: dict[str, logging.FileHandler] = {}
_FMT = "%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    with _lock:
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
            logger.propagate = False
    return logger


def set_level(level: str | int) -> None:
    get_logger().setLevel(level)


def add_file_handler(path: str) -> None:
    logger = get_logger()
    with _lock:
        if path in _file_handlers:
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        handler = logging.FileHandler(path)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        _file_handlers[path] = handler
