"""Deadline watchdog for the SPMD sessions (the port's ``parallel/watchdog.py``).

``config.watchdog_seconds`` guards every session's round call and its
evaluation: each runs under a deadline, and a call that exceeds it raises
``TimeoutError`` naming the round and the phase instead of hanging.  The
guarded call runs on a daemon thread and ends with a device
synchronisation, so work the call only enqueued on the card is inside the
deadline too.  A stalled call cannot be interrupted from Python: on a
timeout it is abandoned on its thread (the run is aborting anyway), and
``training.py::train_with_recovery`` treats the ``TimeoutError`` as a
crash.

The first call of each phase gets ``COMPILE_GRACE`` times the deadline:
the first round builds the kernels and warms the allocator.  With
``watchdog_seconds`` 0 :meth:`DeadlineWatchdog.call` runs ``fn`` inline:
no thread and no synchronisation.
"""

import threading

import torch

from ..utils.logging import get_logger

#: the first call of each phase waits this many deadlines
COMPILE_GRACE = 10.0


class DeadlineWatchdog:
    def __init__(self, seconds: float, device: torch.device | str | None = None):
        self.seconds = float(seconds or 0.0)
        self.device = torch.device(device) if device is not None else None
        self._seen_phases: set[str] = set()

    @classmethod
    def from_config(cls, config, device=None) -> "DeadlineWatchdog":
        return cls(getattr(config, "watchdog_seconds", 0.0) or 0.0, device=device)

    def call(self, fn, *, phase: str, round_number: int):
        """``fn()`` under the deadline; ``TimeoutError`` on a stall.
        ``phase`` keys the first-call grace."""
        if self.seconds <= 0:
            return fn()
        deadline = self.seconds
        if phase not in self._seen_phases:
            self._seen_phases.add(phase)
            deadline *= COMPILE_GRACE
        result: dict = {}
        # autograd's mode is per thread: the guarded call runs in the caller's
        grad_enabled = torch.is_grad_enabled()
        device = self.device

        def target() -> None:
            try:
                with torch.set_grad_enabled(grad_enabled):
                    result["value"] = fn()
                if device is not None and device.type == "cuda":
                    torch.cuda.synchronize(device)
            except BaseException as exc:  # noqa: BLE001 -- raised on the caller's thread
                result["error"] = exc

        thread = threading.Thread(target=target, daemon=True, name=f"spmd-{phase}-r{round_number}")
        thread.start()
        thread.join(deadline)
        if thread.is_alive():
            diag = (
                f"watchdog: SPMD {phase!r} stalled > {deadline:.1f}s at round {round_number}"
                f" (device {device}); aborting"
            )
            get_logger().error(diag)
            raise TimeoutError(diag)
        if "error" in result:
            raise result["error"]
        return result["value"]


__all__ = ["DeadlineWatchdog"]
