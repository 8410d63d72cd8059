"""Asynchronous round checkpoints (the port's ``util/checkpoint.py``).

Every round of the SPMD sessions writes ``aggregated_model/round_N.npz``
in the JAX package's keys and layouts, so either package resumes the
other's ``save_dir``.  :class:`AsyncCheckpointWriter` keeps the write off
the round loop: one worker thread drains a FIFO bounded to one waiting
job, so a best-model promotion queued right after a save chains behind it
without blocking the caller.  Files land through a sibling temp file and
``os.replace`` (:func:`atomic_write`), so a crash never leaves a torn
``round_N.npz`` behind.  A background failure is raised at the next queue
operation (fail fast, the first error wins) and again by :meth:`wait` and
the ``with`` block.

On the card, :meth:`AsyncCheckpointWriter.save_rows` stages a device
tensor with ONE device-to-host copy per row, in its own dtype, into a
pinned host buffer, enqueued on the current stream with
``non_blocking=True``, and records a CUDA event behind it.  The worker
thread waits on that event, splits the host buffer into the JAX
package's arrays as views and writes the npz entry by entry with
``np.savez``'s own writer (a bf16 optimizer state, staged at half the
bytes, is widened to f32 a leaf at a time).  Stream order makes the
caller's later in-place writes to the source safe: they run after the
copy.  Each shape keeps at
most two pinned buffers: a save takes a free one, allocates the second
only while the first is still being written, and else waits for the
older write (with one job queued and one running, that wait is never
longer than the bounded queue's own).  On the CPU the copy is
synchronous.
"""

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
import zipfile
from collections.abc import Callable, Sequence

import numpy as np
import torch

from ..utils.logging import get_logger


class CheckpointError(RuntimeError):
    """Misuse of the checkpoint writer (promoting before any save)."""


def atomic_write(path: str, write_fn, suffix: str = ".tmp") -> None:
    """``write_fn(tmp)`` writes a sibling temp file, which is then renamed
    over ``path``: a reader (or a crash mid-write) never sees a torn file."""
    tmp = f"{path}{suffix}"
    write_fn(tmp)
    os.replace(tmp, path)


def atomic_json_dump(path: str, obj) -> None:
    """``obj`` as JSON, atomically (``round_record.json`` is the resume
    source of the record rows)."""

    def _write(tmp: str) -> None:
        with open(tmp, "wt", encoding="utf8") as f:
            json.dump(obj, f)

    atomic_write(path, _write)


def _savez(path: str, arrays: dict) -> None:
    """``np.savez``'s file and its own writer (``np.lib.format.write_array``
    into an uncompressed zip entry a key), entry by entry, so a tensor is
    taken to numpy only while it is written: an f32 view of a staging
    buffer as a view, a bf16 one widened to f32 one leaf at a time."""

    def _write(tmp: str) -> None:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as archive:
            for key, value in arrays.items():
                if isinstance(value, torch.Tensor):
                    value = value.float().numpy()
                with archive.open(f"{key}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(value), allow_pickle=False)

    atomic_write(path, _write, suffix=".tmp.npz")


@dataclasses.dataclass(eq=False)  # found by identity
class _Staging:
    """A host buffer and whether a queued write still reads it."""

    host: torch.Tensor
    free: threading.Event


@dataclasses.dataclass
class WriteTiming:
    """One queued write: the seconds the caller was blocked queueing it
    (staging the copy included) and the seconds the worker took to write
    it (the wait for the copy included)."""

    path: str
    queue_seconds: float
    write_seconds: float | None = None


#: jobs that may wait behind the one being written: a promotion queued
#: right after a save chains behind it, a third job blocks its caller
MAX_PENDING = 1


class AsyncCheckpointWriter:
    """Background npz writer: one worker thread, a bounded FIFO of jobs."""

    def __init__(self) -> None:
        self._jobs: queue.Queue = queue.Queue(maxsize=MAX_PENDING)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last_path: str | None = None
        self._last_save_ok: list[bool] = [True]
        self._finalizers: dict[str, Callable[[], None]] = {}
        #: (shape, device) -> its staging buffers (at most two), least recently taken first
        self._staging: dict[tuple, list[_Staging]] = {}
        #: every staged write's timing, in queue order
        self.timings: list[WriteTiming] = []

    def register_finalizer(self, name: str, fn: Callable[[], None]) -> None:
        """Run ``fn`` when the ``with`` block exits, before the queue drains
        (the run loops' hook for host state flushed on a cadence, such as
        the ``record_flush_every`` rows).  A name registered again
        replaces its callable; finalizers run on the error path too."""
        self._finalizers[name] = fn

    def _worker(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                if job is not None:
                    job()
            except BaseException as exc:  # noqa: BLE001 -- stored, raised on the caller
                if self._error is None:  # the first error wins
                    self._error = exc
            finally:
                self._jobs.task_done()
            if job is None:  # the shutdown sentinel from wait()
                return

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _submit(self, job) -> None:
        # fail fast: a checkpoint that failed in the background stops the
        # run at the next save, not at its end
        self._raise_pending_error()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, daemon=True, name="checkpoint-writer")
            self._thread.start()
        self._jobs.put(job)  # blocks only while MAX_PENDING jobs wait

    def _queue_write(self, path: str, arrays_fn: Callable[[], dict], timing=None, done=None) -> None:
        succeeded = [False]  # read by a promotion chained behind this save

        def _write() -> None:
            started = time.perf_counter()
            try:
                _savez(path, arrays_fn())
                succeeded[0] = True
            finally:
                if timing is not None:
                    timing.write_seconds = time.perf_counter() - started
                if done is not None:
                    done()

        self._submit(_write)
        self._last_path = path
        self._last_save_ok = succeeded

    def save_npz(self, path: str, arrays: dict) -> None:
        """Queue host ``arrays`` (name -> numpy array) to be written to
        ``path`` as npz."""
        arrays = dict(arrays)
        self._queue_write(path, lambda: arrays)

    def _take_staging(self, shape: tuple[int, ...], dtype: torch.dtype, device: torch.device) -> _Staging:
        """A free staging buffer of ``shape`` and ``dtype`` (pinned for a
        card's copies): a free one, else a second one while the first is
        still being written, else the older of the two once its write is
        done."""
        buffers = self._staging.setdefault((shape, dtype, str(device)), [])
        free = [buffer for buffer in buffers if buffer.free.is_set()]
        if free:
            buffer = free[0]
        elif len(buffers) < 2:
            host = torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
            buffer = _Staging(host, threading.Event())
            buffers.append(buffer)
        else:
            buffer = buffers[0]  # the least recently taken
            buffer.free.wait()
        buffers.remove(buffer)
        buffers.append(buffer)
        buffer.free.clear()
        return buffer

    def save_rows(
        self, path: str, rows: Sequence[torch.Tensor | None], arrays: Callable[[torch.Tensor], dict]
    ) -> None:
        """Queue an npz of ``arrays(host)``, where ``host`` is a
        ``[len(rows), width]`` host copy of ``rows`` (flat tensors of
        ``width`` values in one dtype, on the device or the host; None: a
        row of zeros).  One copy a row, staged as the module docstring says;
        ``arrays`` runs on the worker thread and may return views of
        ``host``, which are written as f32 one at a time."""
        self._raise_pending_error()  # before a buffer is taken: a failed write frees none
        t0 = time.perf_counter()
        present = [row for row in rows if row is not None]
        width, dtype, device = int(present[0].numel()), present[0].dtype, present[0].device
        staging = self._take_staging((len(rows), width), dtype, device)
        event = None
        try:
            for host_row, row in zip(staging.host, rows):
                if row is None:
                    host_row.zero_()
                else:
                    host_row.copy_(row.reshape(-1), non_blocking=device.type == "cuda")
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
            timing = WriteTiming(path, 0.0)
            self.timings.append(timing)

            def host_arrays() -> dict:
                if event is not None:
                    event.synchronize()
                return arrays(staging.host)

            self._queue_write(path, host_arrays, timing, staging.free.set)
        except BaseException:
            staging.free.set()
            raise
        timing.queue_seconds = time.perf_counter() - t0

    def copy_last_to(self, path: str) -> None:
        """Queue a file copy of the last saved checkpoint to ``path``
        (``round_N.npz`` -> ``best_global_model.npz`` with no second fetch
        from the device); it runs after the save it copies."""
        source = self._last_path
        if source is None:
            raise CheckpointError("copy_last_to called before any save — there is no checkpoint to promote")
        save_ok = self._last_save_ok

        def _copy() -> None:
            if not save_ok[0]:
                # the save that made ``source`` failed: do not promote a
                # stale file an earlier run left at that path
                return
            atomic_write(path, lambda tmp: shutil.copyfile(source, tmp), suffix=".tmp.npz")

        self._submit(_copy)

    def barrier(self) -> None:
        """Block until every queued job is done; raise the first background
        error.  The worker thread stays for the next save."""
        self._jobs.join()
        self._raise_pending_error()

    def wait(self) -> None:
        """:meth:`barrier` and stop the worker thread (run end)."""
        self._jobs.join()
        if self._thread is not None and self._thread.is_alive():
            self._jobs.put(None)
            self._thread.join()
        self._thread = None
        self._raise_pending_error()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc_info) -> None:
        # every finalizer, then the drain, and only then a finalizer's
        # error: raising early would abandon queued writes in the worker
        finalizer_error: BaseException | None = None
        for name, fn in list(self._finalizers.items()):
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 -- raised after the drain, or logged while unwinding
                if exc_info[0] is None and finalizer_error is None:
                    finalizer_error = exc
                else:
                    get_logger().warning("finalizer %s failed during error unwind (suppressed): %s", name, exc)
        if exc_info[0] is None:
            self.wait()
            if finalizer_error is not None:
                raise finalizer_error
            return
        try:
            self.wait()
        except Exception as exc:  # noqa: BLE001 -- the run is already unwinding from another error
            get_logger().warning("background checkpoint write failed during error unwind (suppressed): %s", exc)


def jax_views(flat: torch.Tensor, leaves) -> dict[str, torch.Tensor]:
    """A flat vector (or the rows of an ``[S, D]`` matrix) in the port's
    layout as the JAX package's arrays: one view per leaf
    (``models/convert.py::JaxLeaf``), keyed by its JAX key, in the JAX
    layout (``[S, *shape]`` for rows)."""
    lead = tuple(flat.shape[:-1])
    out = {}
    for leaf in leaves:
        view = flat[..., leaf.start : leaf.stop].reshape(*lead, *leaf.shape)
        if leaf.perm is not None:
            view = view.permute(*range(len(lead)), *(p + len(lead) for p in leaf.perm))
        out[leaf.jax_key] = view
    return out


def rows_from_jax(values, leaves, n_rows: int) -> torch.Tensor | None:
    """The inverse of :func:`jax_views` for the rows of an ``[n_rows, D]``
    matrix: ``values[i]`` is ``leaves[i]``'s ``[n_rows, *JAX shape]``
    array.  An f32 CPU tensor, or None where an array's shape does not
    match its leaf's."""
    out = torch.empty(n_rows, sum(leaf.size for leaf in leaves))
    for value, leaf in zip(values, leaves):
        if value.shape != (n_rows, *leaf.jax_shape):
            return None
        rows = torch.from_numpy(np.asarray(value, np.float32))
        if leaf.perm is not None:
            rows = rows.permute(0, *(int(p) + 1 for p in np.argsort(leaf.perm)))
        out[:, leaf.start : leaf.stop] = rows.reshape(n_rows, -1)
    return out


__all__ = [
    "AsyncCheckpointWriter",
    "CheckpointError",
    "WriteTiming",
    "atomic_json_dump",
    "atomic_write",
    "jax_views",
    "rows_from_jax",
]
