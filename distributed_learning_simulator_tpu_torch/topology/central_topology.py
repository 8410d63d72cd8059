"""Hub-and-spoke links between the server thread and the worker threads
(the port's copy of the JAX package's ``topology/central_topology.py``).

An endpoint is a pair of thread-safe queues: messages are handed over by
reference, and parameter payloads stay on the device.  The server endpoint
counts the payload bytes it sends and receives; quantized subclasses encode
before and decode after the count, so it sees wire sizes.  Each endpoint
holds the link's random source (``random`` in ``endpoint_kwargs``,
``ops/quantization.py::CodecRandom``): the codecs draw from it, and so do
the upload transforms of FedDropoutAvg and SMAFD.

Every send, and every receipt of a message that is not ``None``, adds one
to the topology's ``activity`` counter, which the threaded executor's
stall watchdog (``training.py::_watchdog_loop``) reads.
"""

import queue
import threading
from typing import Any

from ..message import Message, get_message_size
from ..ops.quantization import CodecRandom


class _Channel:
    """One direction of a link."""

    def __init__(self, notify: threading.Event | None = None) -> None:
        self._queue: queue.Queue = queue.Queue()
        self._notify = notify

    def put(self, item: Any) -> None:
        self._queue.put(item)
        if self._notify is not None:
            self._notify.set()

    def get(self, timeout: float | None = None) -> Any:
        return self._queue.get(timeout=timeout)

    def has_data(self) -> bool:
        return not self._queue.empty()


class CentralTopology:
    """A star of the server and ``worker_num`` workers."""

    def __init__(self, worker_num: int) -> None:
        self.worker_num = worker_num
        # any worker -> server put wakes the server's event loop
        self.server_wakeup = threading.Event()
        self._to_server = {w: _Channel(notify=self.server_wakeup) for w in range(worker_num)}
        self._to_worker = {w: _Channel() for w in range(worker_num)}
        #: messages moved so far; the stall watchdog reads it
        self.activity = 0

    def record_activity(self) -> None:
        self.activity += 1  # a racy increment still changes the value


class ClientEndpoint:
    """A worker's end of its link."""

    def __init__(self, topology: CentralTopology, worker_id: int, random: CodecRandom | None = None) -> None:
        self._topology = topology
        self.worker_id = worker_id
        self.random = random if random is not None else CodecRandom()

    def send(self, data: Any) -> None:
        self._topology.record_activity()
        self._topology._to_server[self.worker_id].put(data)

    def get(self, timeout: float | None = None) -> Any:
        data = self._topology._to_worker[self.worker_id].get(timeout=timeout)
        if data is not None:
            self._topology.record_activity()
        return data

    def has_data(self) -> bool:
        return self._topology._to_worker[self.worker_id].has_data()

    def close(self) -> None:
        pass


class ServerEndpoint:
    """The server's end of every link, with the byte counters."""

    def __init__(self, topology: CentralTopology, random: CodecRandom | None = None) -> None:
        self._topology = topology
        self.random = random if random is not None else CodecRandom()
        self.received_bytes = 0
        self.sent_bytes = 0

    @property
    def worker_num(self) -> int:
        return self._topology.worker_num

    def has_data(self, worker_id: int) -> bool:
        return self._topology._to_server[worker_id].has_data()

    def get(self, worker_id: int, timeout: float | None = None) -> Any:
        data = self._topology._to_server[worker_id].get(timeout=timeout)
        if isinstance(data, Message):
            self.received_bytes += get_message_size(data)
        if data is not None:
            # a drain is progress too: a phase that only pulls must not trip the watchdog
            self._topology.record_activity()
        return data

    def send(self, worker_id: int, data: Any) -> None:
        if isinstance(data, Message):
            self.sent_bytes += get_message_size(data)
        self._topology.record_activity()
        self._topology._to_worker[worker_id].put(data)

    def broadcast(self, data: Any, worker_ids: set[int] | None = None) -> None:
        for worker_id in range(self.worker_num):
            if worker_ids is None or worker_id in worker_ids:
                self.send(worker_id, data)

    def close(self) -> None:
        pass
