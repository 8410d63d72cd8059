"""Client: a worker wired to the central topology (the port's copy of the
JAX package's ``worker/client.py``).  The endpoint is a thread-safe
queue, so a blocking ``get`` with a timeout that checks for an aborted
task replaces a poll loop.  A worker waiting on the server holds no
training slot (``parallel_number``): it gives its slot back while it
waits, stays without one after an unselected round's ``None`` (its
answer needs no training), and takes one again when work comes."""

import queue
from typing import Any

from .worker import Worker


class Client(Worker):
    def send_data_to_server(self, data: Any) -> None:
        self._endpoint.send(data)

    def _get_data_from_server(self) -> Any:
        owed_slot = self._holds_slot or self._slot_deferred
        self._release_slot()
        while True:
            self._raise_if_aborted()
            try:
                result = self._endpoint.get(timeout=0.5)
                break
            except queue.Empty:
                continue
        if owed_slot:
            self._slot_deferred = result is None
            if result is not None:
                self._acquire_slot()
        return result
