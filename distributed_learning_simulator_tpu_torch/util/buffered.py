"""Buffered-asynchronous aggregation: the deterministic arrival schedule
(the port's ``util/buffered.py``).

``aggregation_mode: buffered`` (FedBuff-style) lets the server merge a
**flush** of the first ``buffer_size`` arrivals with a staleness discount
``1 / (1 + staleness)^staleness_alpha``; a straggler's update lands in a
later flush instead of stalling the round.  The arrivals are scheduled,
not raced: which flush each ``(client, origin round)`` update lands in
follows from the seeded :class:`~.faults.FaultPlan` straggler draws and
the FIFO capacity cascade below, exactly as in the JAX package, so the
SPMD session can replay it in logical time (``parallel/spmd.py``'s
pending ring).

``algorithm_kwargs``::

    aggregation_mode: buffered   # default "synchronous"
    buffer_size: 0               # flush capacity; 0 = unbounded
    staleness_alpha: 0.5         # discount exponent

Queue rule: update ``(c, o)`` is scheduled to land at flush
``o + staleness_rounds(c, o)``; a flush merges at most ``buffer_size``
items, stale ones first (oldest origin, then worker id), then on-time ones
by worker id; the overflow rolls to the next flush one round staler; a
dropped client's update never lands; items landing past the run's last
round are dropped.  A resumed run counts only the items trained after
the resume (``live_cohort``).  The threaded executor follows the same
schedule under its own participation rule (:func:`threaded_uploaders`),
on the servers of :data:`BUFFERED_THREADED_ALGORITHMS`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from ..utils.selection import select_workers
from .faults import FaultPlan

_MODES = ("synchronous", "buffered")


@dataclasses.dataclass(frozen=True)
class BufferedSettings:
    """Parsed ``aggregation_mode`` knobs (None: synchronous)."""

    buffer_size: int = 0  # 0 = unbounded
    staleness_alpha: float = 0.5

    @classmethod
    def from_config(cls, config) -> "BufferedSettings | None":
        """From ``config.algorithm_kwargs``; None when the mode is absent or
        ``synchronous``.  Invalid values, and buffered knobs without the
        buffered mode, raise."""
        kwargs = dict(getattr(config, "algorithm_kwargs", None) or {})
        mode = str(kwargs.get("aggregation_mode") or "synchronous").lower()
        if mode not in _MODES:
            raise ValueError(
                f"algorithm_kwargs.aggregation_mode must be one of {_MODES},"
                f" got {kwargs.get('aggregation_mode')!r}"
            )
        if mode != "buffered":
            for knob in ("buffer_size", "staleness_alpha"):
                if knob in kwargs:
                    raise ValueError(
                        f"algorithm_kwargs.{knob} is set but"
                        " aggregation_mode is not 'buffered' — the knob"
                        " would be silently ignored; drop it or enable"
                        " buffered aggregation"
                    )
            return None
        buffer_size = int(kwargs.get("buffer_size", 0) or 0)
        if buffer_size < 0:
            raise ValueError(f"algorithm_kwargs.buffer_size must be >= 0 (0 = unbounded), got {buffer_size}")
        alpha = float(kwargs.get("staleness_alpha", 0.5))
        if alpha < 0:
            raise ValueError(f"algorithm_kwargs.staleness_alpha must be >= 0, got {alpha}")
        return cls(buffer_size=buffer_size, staleness_alpha=alpha)


#: the threaded servers whose aggregation is a FedAvg merge that a
#: staleness discount can weight
BUFFERED_THREADED_ALGORITHMS = ("fed_avg", "fed_paq")


def threaded_buffered_reason(algorithm: str) -> str | None:
    """Why the threaded executor cannot run ``aggregation_mode: buffered``
    for ``algorithm`` (None: it can), in the JAX package's words."""
    if algorithm not in BUFFERED_THREADED_ALGORITHMS:
        return f"the {algorithm!r} aggregation semantics are not a staleness-weightable FedAvg merge"
    return None


def staleness_discount(staleness: int, alpha: float) -> float:
    """``1 / (1 + s)^alpha`` in host float64."""
    return float((1.0 + float(staleness)) ** (-float(alpha)))


@dataclasses.dataclass(frozen=True)
class FlushItem:
    """``worker``'s round-``origin`` upload, merged ``staleness`` flushes
    late with weight factor ``discount``."""

    worker: int
    origin: int
    staleness: int
    discount: float


@dataclasses.dataclass(frozen=True)
class ArrivalSchedule:
    """The flush membership of a whole run."""

    flushes: dict[int, tuple[FlushItem, ...]]
    #: (worker, origin) -> the flush it lands at (missing: never lands)
    landing: dict[tuple[int, int], int]
    max_staleness: int
    staleness_alpha: float

    def delay(self, worker: int, origin: int) -> int | None:
        """Flushes the (worker, origin) update waits, or None when it
        never lands."""
        land = self.landing.get((worker, origin))
        return None if land is None else land - origin

    def cohort(self, flush_round: int) -> tuple[FlushItem, ...]:
        return self.flushes.get(flush_round, ())

    def live_cohort(self, flush_round: int, origin_floor: int = 1) -> tuple[FlushItem, ...]:
        """The cohort items that can still arrive: a resumed run restarts at
        the resume round, so items whose origin lies below ``origin_floor``
        died with the killed process (a resume drains the buffer)."""
        return tuple(item for item in self.cohort(flush_round) if item.origin >= origin_floor)

    def stale_count(self, flush_round: int, origin_floor: int = 1) -> int:
        return sum(1 for item in self.live_cohort(flush_round, origin_floor) if item.staleness)

    def buffer_depth_after(self, flush_round: int, origin_floor: int = 1) -> int:
        """Updates still in flight after this flush: trained at or before
        it (and at or after ``origin_floor``), landing later."""
        return sum(
            1 for (_w, origin), land in self.landing.items() if origin_floor <= origin <= flush_round < land
        )


def compute_arrival_schedule(
    settings: BufferedSettings,
    plan: FaultPlan | None,
    worker_number: int,
    total_rounds: int,
    uploaders: Callable[[int], tuple[int, ...]],
) -> ArrivalSchedule:
    """The queue process of the module docstring over the whole run.
    ``uploaders(round)`` names the workers whose round upload exists;
    dropped clients are excluded here."""
    pending: dict[int, list[tuple[int, int]]] = {}  # landing -> [(origin, worker)]
    flushes: dict[int, tuple[FlushItem, ...]] = {}
    landing: dict[tuple[int, int], int] = {}
    max_staleness = 0
    capacity = settings.buffer_size
    for flush_round in range(1, total_rounds + 1):
        dropped = plan.dropped_clients(flush_round, worker_number) if plan is not None else frozenset()
        for worker in sorted(uploaders(flush_round)):
            if worker in dropped:
                continue  # the upload is lost, not late
            staleness = plan.staleness_rounds(flush_round, worker, worker_number) if plan is not None else 0
            pending.setdefault(flush_round + staleness, []).append((flush_round, worker))
        # stale items first (by origin, worker), then the on-time ones
        candidates = sorted(pending.pop(flush_round, ()))
        if capacity and len(candidates) > capacity:
            pending.setdefault(flush_round + 1, []).extend(candidates[capacity:])
            candidates = candidates[:capacity]
        cohort = []
        for origin, worker in candidates:
            staleness = flush_round - origin
            max_staleness = max(max_staleness, staleness)
            landing[(worker, origin)] = flush_round
            cohort.append(
                FlushItem(
                    worker=worker,
                    origin=origin,
                    staleness=staleness,
                    discount=staleness_discount(staleness, settings.staleness_alpha),
                )
            )
        flushes[flush_round] = tuple(cohort)
    return ArrivalSchedule(
        flushes=flushes,
        landing=landing,
        max_staleness=max_staleness,
        staleness_alpha=settings.staleness_alpha,
    )


def selection_uploaders(config) -> Callable[[int], tuple[int, ...]]:
    """The SPMD session's participation rule: the round's selected workers."""

    def uploaders(round_number: int) -> tuple[int, ...]:
        return tuple(
            sorted(
                select_workers(
                    config.seed,
                    round_number,
                    config.worker_number,
                    config.algorithm_kwargs.get("random_client_number"),
                )
            )
        )

    return uploaders


def threaded_uploaders(config) -> Callable[[int], tuple[int, ...]]:
    """The threaded executor's participation rule.  Its server selects at
    send time with its current round counter, and the initial broadcast
    and round 1's result both select with round 1, so collection round
    ``o``'s uploaders are ``select_workers(seed, max(1, o - 1))``: one round
    behind :func:`selection_uploaders` under partial participation, the
    same under full participation."""

    def uploaders(round_number: int) -> tuple[int, ...]:
        return selection_uploaders(config)(max(1, round_number - 1))

    return uploaders


__all__ = [
    "ArrivalSchedule",
    "BUFFERED_THREADED_ALGORITHMS",
    "BufferedSettings",
    "FlushItem",
    "compute_arrival_schedule",
    "selection_uploaders",
    "staleness_discount",
    "threaded_buffered_reason",
    "threaded_uploaders",
]
