"""Deterministic fault injection (the port's ``util/faults.py``).

A :class:`FaultPlan` is a seeded schedule of client dropouts, straggler
delays and corrupt uploads, read from ``config.fault_tolerance``:

.. code-block:: yaml

    fault_tolerance:
      seed: 0                      # the fault stream's seed (not the training seed)
      dropout_rate: 0.1            # per-(round, client) Bernoulli dropout
      dropout_schedule: {2: [0, 3]}  # explicit per-round dropped worker ids
      straggler_rate: 0.0          # per-(round, client) straggle draw ...
      straggler_delay_seconds: 0.0 # ... each delayed this long
      straggler_delay_spread: 0.0  # seeded per-client delay multiplier in [1, 1 + spread)
      straggler_schedule: {}
      corrupt_rate: 0.0            # per-(round, client) poisoned upload
      corrupt_schedule: {}
      update_guard: false          # on-device non-finite / norm reject
      max_update_norm: 0.0         # 0 = finiteness only; > 0 turns the guard on

Every draw is keyed by ``(fault seed, round, stream)`` exactly as in the
JAX package, so the same config gives the same dropped, straggling and
corrupt sets, delays and staleness in both packages.

On the SPMD FedAvg session the plan folds into the host-built weight row
(:func:`apply_fault_plan`): a dropped client weighs 0, a corrupt one NaN
(the update guard rejects it; without the guard it poisons the aggregate
visibly), the host sleeps once for the slowest straggler, and a round
whose survivors fall below the quorum raises :class:`QuorumLostError`.

``kill_after_rounds`` schedules a simulated process kill
(:class:`SimulatedPreemption`).  A session with round checkpoints arms it
(:meth:`FaultPlan.arm_kill`) and fires it (:meth:`FaultPlan.fire_armed_kill`)
only once a checkpoint at or past the killed round exists and the record
rows are flushed, so a sparse ``checkpoint_every`` or a horizon defers the
kill to the next durable boundary and a resumed run, which starts past the
killed round, never meets it again; sign_SGD, which writes no round
checkpoints, raises at once (:meth:`FaultPlan.maybe_kill`).  ``auto_resume``,
``max_restarts`` and ``restart_backoff_seconds`` are the supervisor's
(``training.py::train_with_recovery``).

On the threaded executor the plan acts at the upload boundary
(``worker/aggregation_worker.py::_inject_upload_faults``): a straggler
sleeps its own seeded delay, a dropped worker sends ``None``, a corrupt
one NaN-fills its upload (:meth:`FaultPlan.poison_params`), and the
server guards and counts what arrives.  ``client_faults_nonfatal``
belongs to that executor: a crashed or stalled worker becomes a
permanent dropout.
"""

import dataclasses
import math
import random
import time
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from ..models.convert import _jax_key
from ..utils.logging import get_logger


class ClientFaultError(RuntimeError):
    """An injected (or real) client-side fault on the threaded executor."""


class QuorumLostError(RuntimeError):
    """A round's surviving uploads fell below ``min_client_quorum``."""


class SimulatedPreemption(RuntimeError):
    """A FaultPlan-scheduled process kill."""


_KNOWN_KEYS = frozenset(
    {
        "seed",
        "dropout_rate",
        "dropout_schedule",
        "straggler_rate",
        "straggler_delay_seconds",
        "straggler_delay_spread",
        "straggler_schedule",
        "corrupt_rate",
        "corrupt_schedule",
        "kill_after_rounds",
        "update_guard",
        "max_update_norm",
        "client_faults_nonfatal",
        "auto_resume",
        "max_restarts",
        "restart_backoff_seconds",
    }
)

# stream ids keep the per-round Bernoulli draws independent per fault class
_DROPOUT_STREAM = 1
_STRAGGLER_STREAM = 2
_CORRUPT_STREAM = 3
_DELAY_STREAM = 4


def _normalize_schedule(raw: Any) -> dict[int, frozenset[int]]:
    """YAML schedules arrive with string keys and list (or int) values:
    ``{round: frozenset(worker_ids)}``."""
    if not raw:
        return {}
    out: dict[int, frozenset[int]] = {}
    for key, ids in dict(raw).items():
        if isinstance(ids, int):
            ids = [ids]
        out[int(key)] = frozenset(int(i) for i in ids)
    return out


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    dropout_rate: float = 0.0
    dropout_schedule: Mapping[int, frozenset[int]] = dataclasses.field(default_factory=dict)
    straggler_rate: float = 0.0
    straggler_delay_seconds: float = 0.0
    #: each straggling (round, client) draws a multiplier in [1, 1 + spread)
    #: on ``straggler_delay_seconds``; buffered aggregation derives its
    #: staleness in rounds from the same draw
    straggler_delay_spread: float = 0.0
    straggler_schedule: Mapping[int, frozenset[int]] = dataclasses.field(default_factory=dict)
    corrupt_rate: float = 0.0
    corrupt_schedule: Mapping[int, frozenset[int]] = dataclasses.field(default_factory=dict)
    kill_after_rounds: tuple[int, ...] = ()
    update_guard: bool = False
    max_update_norm: float = 0.0
    client_faults_nonfatal: bool = False
    auto_resume: bool = False
    max_restarts: int = 2
    restart_backoff_seconds: float = 1.0

    @classmethod
    def from_config(cls, config) -> "FaultPlan | None":
        """The plan of ``config.fault_tolerance`` (None when it is absent or
        empty).  Unknown keys raise."""
        raw = dict(getattr(config, "fault_tolerance", None) or {})
        if not raw:
            return None
        unknown = set(raw) - _KNOWN_KEYS
        if unknown:
            raise ValueError(f"unknown fault_tolerance keys {sorted(unknown)}; known: {sorted(_KNOWN_KEYS)}")
        kills = raw.get("kill_after_rounds") or ()
        if isinstance(kills, int):
            kills = (kills,)
        max_norm = float(raw.get("max_update_norm", 0.0) or 0.0)
        return cls(
            seed=int(raw.get("seed", 0) or 0),
            dropout_rate=float(raw.get("dropout_rate", 0.0) or 0.0),
            dropout_schedule=_normalize_schedule(raw.get("dropout_schedule")),
            straggler_rate=float(raw.get("straggler_rate", 0.0) or 0.0),
            straggler_delay_seconds=float(raw.get("straggler_delay_seconds", 0.0) or 0.0),
            straggler_delay_spread=float(raw.get("straggler_delay_spread", 0.0) or 0.0),
            straggler_schedule=_normalize_schedule(raw.get("straggler_schedule")),
            corrupt_rate=float(raw.get("corrupt_rate", 0.0) or 0.0),
            corrupt_schedule=_normalize_schedule(raw.get("corrupt_schedule")),
            kill_after_rounds=tuple(int(r) for r in kills),
            update_guard=bool(raw.get("update_guard", False)) or max_norm > 0,
            max_update_norm=max_norm,
            client_faults_nonfatal=bool(raw.get("client_faults_nonfatal", False)),
            auto_resume=bool(raw.get("auto_resume", False)),
            max_restarts=int(raw.get("max_restarts", 2)),
            restart_backoff_seconds=float(raw.get("restart_backoff_seconds", 1.0)),
        )

    @property
    def injection_active(self) -> bool:
        """Whether the plan ever injects anything (a guard-only plan leaves
        every round untouched, bit for bit)."""
        return bool(
            self.dropout_rate
            or self.dropout_schedule
            or self.straggler_rate
            or self.straggler_schedule
            or self.corrupt_rate
            or self.corrupt_schedule
            or self.kill_after_rounds
        )

    def _draw(self, stream: int, round_number: int, worker_number: int, rate: float, schedule) -> frozenset[int]:
        scheduled = schedule.get(round_number, frozenset())
        if rate <= 0.0:
            return scheduled
        rng = random.Random((self.seed * 1_000_003 + round_number) * 31 + stream)
        return scheduled | frozenset(w for w in range(worker_number) if rng.random() < rate)

    def dropped_clients(self, round_number: int, worker_number: int) -> frozenset[int]:
        return self._draw(_DROPOUT_STREAM, round_number, worker_number, self.dropout_rate, self.dropout_schedule)

    def straggling_clients(self, round_number: int, worker_number: int) -> frozenset[int]:
        return self._draw(
            _STRAGGLER_STREAM, round_number, worker_number, self.straggler_rate, self.straggler_schedule
        )

    def corrupt_clients(self, round_number: int, worker_number: int) -> frozenset[int]:
        return self._draw(_CORRUPT_STREAM, round_number, worker_number, self.corrupt_rate, self.corrupt_schedule)

    def _delay_multiplier(self, round_number: int, worker_id: int) -> float:
        """The seeded per-(round, client) multiplier in ``[1, 1 + spread)``."""
        if self.straggler_delay_spread <= 0:
            return 1.0
        rng = random.Random(
            ((self.seed * 1_000_003 + round_number) * 31 + _DELAY_STREAM) * 1_000_003 + worker_id
        )
        return 1.0 + self.straggler_delay_spread * rng.random()

    def straggler_delay(self, round_number: int, worker_id: int, worker_number: int) -> float:
        """This client's upload delay (seconds) for the round: 0 unless it
        straggles."""
        if worker_id not in self.straggling_clients(round_number, worker_number):
            return 0.0
        return self.straggler_delay_seconds * self._delay_multiplier(round_number, worker_id)

    def staleness_rounds(self, round_number: int, worker_id: int, worker_number: int) -> int:
        """Buffer flushes this client's round upload misses (0 = on time):
        ``straggler_delay_seconds`` is one round's wall clock, so a
        straggler misses ``ceil(multiplier)`` flushes (1 with no delay
        configured)."""
        if worker_id not in self.straggling_clients(round_number, worker_number):
            return 0
        if self.straggler_delay_seconds <= 0:
            return 1
        return max(1, math.ceil(self._delay_multiplier(round_number, worker_id) - 1e-9))

    def straggler_sleep(self, round_number: int, worker_number: int, worker_id: int | None = None) -> None:
        """The host's straggler delay.  With ``worker_id`` (the threaded
        executor): that worker's own seeded delay, if it straggles this
        round.  Without (the lock-step SPMD round, which ends when its
        slowest upload arrives): one sleep for the slowest straggler."""
        if self.straggler_delay_seconds <= 0:
            return
        straggling = self.straggling_clients(round_number, worker_number)
        if worker_id is not None:
            if worker_id in straggling:
                time.sleep(self.straggler_delay(round_number, worker_id, worker_number))
            return
        if straggling:
            time.sleep(max(self.straggler_delay(round_number, w, worker_number) for w in straggling))


    def should_kill_after(self, round_number: int) -> bool:
        return round_number in self.kill_after_rounds

    def maybe_kill(self, round_number: int) -> None:
        """Raise :class:`SimulatedPreemption` when a kill is scheduled after
        ``round_number``: the variant without deferral, for sessions with
        no round checkpoints (sign_SGD)."""
        if self.should_kill_after(round_number):
            raise SimulatedPreemption(f"fault plan: simulated process kill after round {round_number}")

    def arm_kill(self, first_round: int, last_round: int, armed: int | None) -> int | None:
        """The armed kill's round after rounds ``first_round..last_round``
        ran: the earliest scheduled kill among them beats a later armed
        one."""
        for r in range(first_round, last_round + 1):
            if self.should_kill_after(r) and (armed is None or r < armed):
                armed = r
        return armed

    def fire_armed_kill(self, armed: int | None, durable_round: int, record_durable: bool = True) -> None:
        """Raise :class:`SimulatedPreemption` for an armed kill once the run
        can resume past it: a checkpoint at round ``durable_round`` >= the
        armed round exists and its record rows are flushed."""
        if armed is not None and record_durable and durable_round >= armed:
            raise SimulatedPreemption(
                f"fault plan: simulated process kill after round {armed} (fired at durable round {durable_round})"
            )

    def poison_params(self, params: dict) -> dict:
        """The threaded executor's corruption: the upload's tensor whose JAX
        key sorts first (the JAX package's choice) replaced in the dict by
        a NaN-filled one on its own device, so no tensor the worker still
        holds changes; the server's update guard must reject it."""
        if params:
            name = min(params, key=lambda k: _jax_key(k, params[k].ndim)[0])
            params[name] = torch.full_like(params[name], float("nan"))
        return params

    @property
    def only_recovery(self) -> bool:
        """Whether the plan holds nothing but the kill schedule and the
        supervisor's knobs (the part every SPMD session takes)."""
        return not (
            self.dropout_rate
            or self.dropout_schedule
            or self.straggler_rate
            or self.straggler_schedule
            or self.straggler_delay_seconds
            or self.corrupt_rate
            or self.corrupt_schedule
            or self.update_guard
            or self.client_faults_nonfatal
        )


def apply_fault_plan(
    plan: FaultPlan | None,
    min_quorum: int,
    round_number: int,
    ids,
    weights: np.ndarray,
    worker_number: int | None = None,
) -> np.ndarray:
    """Fold one round's faults into a host-built weight row, in place, and
    enforce the quorum: dropped ids weigh 0, corrupt ids NaN (dropout wins),
    one host sleep for the slowest straggler, and survivors below the
    quorum raise :class:`QuorumLostError` (any plan that injects enforces
    a floor of 1).  ``ids[pos]`` names the worker of each position (None:
    the position is the worker id); ``worker_number`` sizes the draws."""
    injecting = plan is not None and plan.injection_active
    if injecting:
        worker_ids = np.asarray(ids) if ids is not None else np.arange(len(weights))
        population = int(worker_number) if worker_number else len(worker_ids)
        dropped = plan.dropped_clients(round_number, population)
        corrupt = plan.corrupt_clients(round_number, population)
        if dropped or corrupt:
            for pos, wid in enumerate(worker_ids):
                if not weights[pos]:
                    continue  # unselected slot
                if int(wid) in dropped:
                    weights[pos] = 0.0
                elif int(wid) in corrupt:
                    weights[pos] = np.nan
        plan.straggler_sleep(round_number, population)
    quorum = max(int(min_quorum or 0), 1 if injecting else 0)
    if quorum:
        survivors = int((weights > 0).sum())  # NaN > 0 is False
        if survivors < quorum:
            message = (
                f"round {round_number}: {survivors} surviving clients below "
                f"min_client_quorum={quorum} — aborting the round loudly "
                "instead of aggregating a degenerate cohort"
            )
            get_logger().error(message)
            raise QuorumLostError(message)
    return weights


__all__ = ["ClientFaultError", "FaultPlan", "QuorumLostError", "SimulatedPreemption", "apply_fault_plan"]
