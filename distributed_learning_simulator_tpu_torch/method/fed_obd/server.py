"""FedOBD server role (the port's copy of the JAX package's
``method/fed_obd/server.py``): a thin adapter over the phase driver
(``driver.py``).  Phase 1 selects random clients and records a row a
round; phase 2 aggregates every worker's epoch (``in_round`` uploads)
and records the rows whose uploads carry ``check_acc``.  Global-model
broadcasts ride the same codec as uploads (``quant_broadcast``: QSGD for
fed_obd_sq, NNADQ for fed_obd): each is encoded once for all its
receivers.  With ``second_phase_epoch == 1`` the ``k``-th aggregate's QSGD
broadcast draws the FedOBD session's broadcast draws of aggregate ``k -
1``, each leaf by its position (``set_quant_key``).

A resume (``algorithm_kwargs.resume_dir``) restores the record and then
replays the phase driver over the recorded phases
(``driver.py::replay_resume``, the SPMD session's replay): a superseded
tail is dropped and training goes on from the last kept aggregate, and
the initial broadcast tells the workers when they resume into phase 2.
The phase driver owns the rounds, so ``aggregation_mode: buffered``
raises the JAX package's ``ValueError``."""

from typing import Any

from ...algorithm.fed_avg_algorithm import FedAVGAlgorithm
from ...message import ParameterMessage, ParameterMessageBase
from ...models.convert import jax_positions
from ...ops.quantization import SessionKey
from ...server.aggregation_server import AggregationServer
from ...topology.quantized_endpoint import QuantServerEndpoint
from ...utils.logging import get_logger
from ...util.resume import load_round_checkpoint
from .driver import EPOCH_TUNE, PHASE_TWO_KEY, ObdRoundDriver, replay_resume


class FedOBDServer(AggregationServer):
    _buffered_capable = False

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("algorithm", FedAVGAlgorithm())
        super().__init__(**kwargs)
        self._driver = ObdRoundDriver.from_config(self.config)
        self._last_phase_name = ""  # phase that produced the pending row
        self._bcast_count = 0  # aggregates broadcast so far: the keyed broadcasts' stream
        assert isinstance(self._endpoint, QuantServerEndpoint)
        self._endpoint.quant_broadcast = True

    def _annotate_stat(self, round_stat: dict) -> None:
        if self._last_phase_name:
            round_stat["phase"] = self._last_phase_name

    def _try_resume(self):
        """The base resume, then the driver fast-forwarded over the recorded
        phases; round, parameters and the broadcast count follow the kept
        prefix."""
        resumed = super()._try_resume()
        if resumed is None:
            return None
        stats = self.performance_stat
        total = len([k for k in stats if k > 0])
        kept_keys, phase1_kept = replay_resume(self._driver, stats)
        for stale in [k for k in stats if k > 0 and k not in kept_keys]:
            del stats[stale]
        # each kept aggregate was broadcast once: the keyed broadcasts go on from there
        self._bcast_count = len(kept_keys)
        self._round_number = phase1_kept + 1
        if kept_keys and len(kept_keys) < total:
            kept = load_round_checkpoint(self.config.algorithm_kwargs["resume_dir"], kept_keys[-1])
            if kept is not None:
                resumed = kept
        get_logger().info(
            "resume: fed_obd driver fast-forwarded to %s (round -> %d)",
            self._driver.phase.name if self._driver.phase else "finished",
            self._round_number,
        )
        return resumed

    def _init_annotations(self) -> dict:
        """A resume into phase 2 tells the new workers on the initial
        broadcast (they never saw the switch)."""
        return {PHASE_TWO_KEY: True} if self._driver.phase is EPOCH_TUNE else {}

    def _select_workers(self) -> set[int]:
        phase = self._driver.phase
        if phase is not None and not phase.select_all:
            return super()._select_workers()
        return set(range(self.worker_number))

    def _get_stat_key(self) -> int:
        # phase-2 rows land while the round counter stands: append
        if not self.performance_stat:
            return super()._get_stat_key()
        return max(self.performance_stat) + 1

    def _maybe_early_stop(self, result) -> None:
        """The phase driver owns plateau handling."""

    def _aggregate_worker_data(self) -> ParameterMessageBase:
        result = super()._aggregate_worker_data()
        self._last_phase_name = self._driver.phase.name if self._driver.phase else ""
        improved = True
        if self._driver.early_stop and self.performance_stat:
            improved = not self._convergent()
        decision = self._driver.after_aggregate(
            improved=improved,
            worker_ended=result.end_training,
            check_acc="check_acc" in result.other_data,
        )
        self._compute_stat = decision.record_metric
        if decision.annotations:
            get_logger().info("phase switch -> %s", self._driver.phase and self._driver.phase.name)
            result.other_data.update(decision.annotations)
        if decision.end_training:
            get_logger().info("stop aggregation")
            result.end_training = True
            self._driver.stop_now()
        return result

    def _before_send_result(self, result) -> None:
        super()._before_send_result(result)
        if (
            isinstance(result, ParameterMessage)
            and not result.is_initial
            and hasattr(self._endpoint, "set_quant_key")
            and int(self.config.algorithm_kwargs.get("second_phase_epoch", 0)) == 1
        ):
            layout = self._task_context.engine.layout
            self._bcast_count += 1
            self._endpoint.set_quant_key(
                SessionKey(self.config.seed, self._bcast_count - 1, None),
                fold_indices=jax_positions(layout.keys, layout.shapes),
            )

    def _stopped(self) -> bool:
        return self._driver.finished
