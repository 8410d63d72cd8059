"""Host-side FedOBD phase driver (the port's copy of the JAX package's
``method/fed_obd/driver.py``: pure Python, the same code; only this
paragraph is new).  The port's threaded server consults it; the SPMD
session it also drives in the JAX package is not ported yet.

The reference implements FedOBD's two-phase protocol as a pair of mirrored
state machines buried in role callbacks
(``simulation_lib/method/fed_obd/worker.py:12-74`` /
``server.py:10-61``): each side flips a private enum and re-derives the
other's behavior from message annotations.  This framework hoists the
schedule out of the roles entirely:

* the two phases are **data** (:class:`PhaseSpec` records listing selection
  policy, aggregation cadence, upload transform, and client-side settings);
* one :class:`ObdRoundDriver` owns every transition rule (round budget,
  plateau early-stop, epoch budget, worker end signal);
* the threaded server consults the driver after each aggregation, the
  threaded worker applies the spec the server's annotation names, and the
  SPMD session (``parallel/spmd_obd.py``) iterates the very same driver's
  phase stream — so round structure cannot drift between executors.
"""

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """Everything one FedOBD phase means, for both roles."""

    name: str
    #: server: broadcast to everyone instead of a random subset
    select_all: bool
    #: aggregate per local epoch (``in_round`` uploads) instead of per round
    epoch_cadence: bool
    #: client upload transform: opportunistic block dropout + delta vs the
    #: cached global (phase 1) or a plain parameter diff (phase 2)
    block_dropout: bool
    #: client keeps its lr-schedule position across the phase switch
    reuse_learning_rate: bool
    #: ``in_round`` uploads carry ``check_acc`` so the server still records
    #: a test metric for them
    check_acc: bool


BLOCK_DROPOUT_ROUNDS = PhaseSpec(
    name="block_dropout_rounds",
    select_all=False,
    epoch_cadence=False,
    block_dropout=True,
    reuse_learning_rate=False,
    check_acc=False,
)

EPOCH_TUNE = PhaseSpec(
    name="epoch_tune",
    select_all=True,
    epoch_cadence=True,
    block_dropout=False,
    reuse_learning_rate=True,
    check_acc=True,
)

#: the wire annotation announcing the switch into :data:`EPOCH_TUNE`
#: (reference ``other_data["phase_two"]``, ``fed_obd/server.py:38-44``)
PHASE_TWO_KEY = "phase_two"


def replay_resume(driver, entries: dict[int, dict]) -> tuple[list[int], int]:
    """Shared resume replay for BOTH executors: feed the recorded phase
    sequence (rows keyed > 0, in key order) through
    :meth:`ObdRoundDriver.fast_forward`.  Returns ``(kept keys, phase-1
    ticks)``; the caller drops rows beyond the kept prefix."""
    from ...utils.logging import get_logger

    keys = sorted(k for k in entries if k > 0)
    names = [entries[k].get("phase", "") for k in keys]
    kept, phase1_ticks = driver.fast_forward(names)
    if kept < len(keys):
        get_logger().info(
            "resume: dropping %d recorded aggregates from a superseded "
            "schedule (from key %d on)",
            len(keys) - kept,
            keys[kept],
        )
    return keys[:kept], phase1_ticks

SPEC_BY_NAME = {spec.name: spec for spec in (BLOCK_DROPOUT_ROUNDS, EPOCH_TUNE)}


@dataclasses.dataclass
class Decision:
    """What the server should do with the aggregate it just produced."""

    annotations: dict[str, Any]
    end_training: bool
    record_metric: bool


class ObdRoundDriver:
    """Owns FedOBD phase progression.

    Transition rules (reference behavior, re-centralized):

    * ``block_dropout_rounds`` → ``epoch_tune`` when the round budget is
      spent, or on an accuracy plateau under ``early_stop``;
    * ``epoch_tune`` → done when the epoch budget is spent (the threaded
      worker announces this with ``end_training`` on its last epoch), or on
      a plateau under ``early_stop``.
    """

    def __init__(
        self, total_rounds: int, second_phase_epoch: int, early_stop: bool
    ) -> None:
        self.total_rounds = max(1, int(total_rounds))
        self.second_phase_epoch = max(1, int(second_phase_epoch))
        self.early_stop = bool(early_stop)
        self._schedule: list[PhaseSpec] = [BLOCK_DROPOUT_ROUNDS, EPOCH_TUNE]
        self._tick = 0  # aggregations completed in the current phase

    @classmethod
    def from_config(cls, config) -> "ObdRoundDriver":
        kwargs = config.algorithm_kwargs
        return cls(
            total_rounds=config.round,
            second_phase_epoch=int(kwargs["second_phase_epoch"]),
            early_stop=bool(kwargs.get("early_stop", False)),
        )

    @property
    def phase(self) -> PhaseSpec | None:
        return self._schedule[0] if self._schedule else None

    @property
    def finished(self) -> bool:
        return not self._schedule

    def budget(self, spec: PhaseSpec | None = None) -> int:
        spec = spec or self.phase
        assert spec is not None
        return self.second_phase_epoch if spec.epoch_cadence else self.total_rounds

    @property
    def remaining(self) -> int:
        """Aggregations left in the current phase's budget — what a fused
        dispatch may clamp its horizon to so phase switches always land on
        horizon boundaries (plateau early-stop can still end a phase
        sooner, which is why fusion runs per-round under ``early_stop``)."""
        return 0 if self.finished else self.budget() - self._tick

    def stop_now(self) -> None:
        self._schedule.clear()

    def fast_forward(self, phase_names: list[str]) -> int:
        """Resume support: advance the driver to match a RECORDED sequence
        of per-aggregate phase names (one source of truth for both
        executors' resume paths).

        The record already reflects whatever plateau/budget decisions the
        original run made, so no ``improved`` guessing happens here: a
        recorded name equal to the current phase consumes one tick; a name
        equal to the NEXT scheduled phase mid-budget follows the recorded
        switch ONLY when ``early_stop`` could have produced it (a plateau
        switch) — otherwise a mid-budget switch can only come from a
        SUPERSEDED schedule (e.g. the round budget was raised since) and
        the replay stops there.  Returns ``(consumed, phase1_ticks)`` —
        how many entries were consumed (the caller drops the rest) and how
        many of those counted against the block-dropout phase (the round
        counter's resume value; attribution happens HERE because untagged
        rows belong to whatever phase the replay was in)."""
        kept = 0
        phase1_ticks = 0
        for name in phase_names:
            if self.finished:
                break
            # untagged rows (records predating phase tagging) count against
            # the current phase
            if name and name != self.phase.name:
                if (
                    self.early_stop
                    and len(self._schedule) > 1
                    and name == self._schedule[1].name
                ):
                    self._schedule.pop(0)
                    self._tick = 0
                else:
                    break
            if self.phase.block_dropout:
                phase1_ticks += 1
            self._tick += 1
            kept += 1
            if self._tick >= self.budget():
                self._schedule.pop(0)
                self._tick = 0
        return kept, phase1_ticks

    def after_aggregate(
        self,
        *,
        improved: bool = True,
        worker_ended: bool = False,
        check_acc: bool = False,
    ) -> Decision:
        """Advance one tick and decide the aggregate's disposition.

        ``improved`` is the caller's plateau test (False = converged under
        the 5-point window); ``worker_ended`` / ``check_acc`` mirror the
        upload annotations on the threaded path.
        """
        spec = self.phase
        if spec is None:
            return Decision({}, end_training=True, record_metric=False)
        self._tick += 1
        record = (not spec.epoch_cadence) or check_acc
        if worker_ended:
            # a worker announced its last epoch — record and wind down
            self.stop_now()
            return Decision({}, end_training=False, record_metric=record)
        annotations: dict[str, Any] = {}
        end_training = False
        plateau = self.early_stop and not improved
        if self._tick >= self.budget(spec) or plateau:
            self._schedule.pop(0)
            self._tick = 0
            if self.finished:
                end_training = True
            else:
                annotations[PHASE_TWO_KEY] = True
        return Decision(annotations, end_training, record_metric=record)
