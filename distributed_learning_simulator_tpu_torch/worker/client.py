"""Client: a worker wired to the central topology (the port's copy of the
JAX package's ``worker/client.py``).  The endpoint is a thread-safe
queue, so a blocking ``get`` with a timeout that checks for an aborted
task replaces a poll loop."""

import queue
from typing import Any

from .worker import Worker


class Client(Worker):
    def send_data_to_server(self, data: Any) -> None:
        self._endpoint.send(data)

    def _get_data_from_server(self) -> Any:
        while True:
            self._raise_if_aborted()
            try:
                return self._endpoint.get(timeout=0.5)
            except queue.Empty:
                continue
