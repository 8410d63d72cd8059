"""Executor base of the threaded executor's server and workers (the port's
copy of the JAX package's ``executor.py``): a name for log attribution,
the save-dir convention and the abort check of the blocking loops."""

import copy
import os
import threading

from .ml_type import TaskAbortedError


class ExecutorContext:
    """Names the current thread after the executor while it runs."""

    def __init__(self, name: str) -> None:
        self._name = name

    def __enter__(self) -> "ExecutorContext":
        threading.current_thread().name = self._name
        return self

    def __exit__(self, *exc) -> None:
        threading.current_thread().name = "dls-idle"


class Executor:
    def __init__(self, config, name: str, task_context) -> None:
        self.config = copy.copy(config)
        self._name = name
        self._task_context = task_context

    @property
    def name(self) -> str:
        return self._name

    @property
    def save_dir(self) -> str:
        save_dir = os.path.join(self.config.save_dir, self._name.replace(" ", "_"))
        os.makedirs(save_dir, exist_ok=True)
        return save_dir

    def _get_execution_context(self) -> ExecutorContext:
        return ExecutorContext(self._name)

    def _raise_if_aborted(self) -> None:
        if self._task_context is not None and self._task_context.aborted():
            raise TaskAbortedError(self._name)

    def start(self) -> None:
        raise NotImplementedError
