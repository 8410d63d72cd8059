"""Wall-clock timing (the port's copy of the JAX package's
``utils/timer.py``; reference: ``cyy_naive_lib.time_counter.TimeCounter``)."""

import time


class TimeCounter:
    def __init__(self) -> None:
        self._start = time.monotonic()

    def reset_start_time(self) -> None:
        self._start = time.monotonic()

    def elapsed_seconds(self) -> float:
        return time.monotonic() - self._start

    def elapsed_milliseconds(self) -> float:
        return self.elapsed_seconds() * 1000.0
