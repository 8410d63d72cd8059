"""FedOBD server role (the port's copy of the JAX package's
``method/fed_obd/server.py``): a thin adapter over the phase driver
(``driver.py``).  Phase 1 selects random clients and records a row a
round; phase 2 aggregates every worker's epoch (``in_round`` uploads)
and records the rows whose uploads carry ``check_acc``.  Global-model
broadcasts ride the same QSGD codec as uploads (``quant_broadcast``):
each is encoded once for all its receivers."""

from typing import Any

from ...algorithm.fed_avg_algorithm import FedAVGAlgorithm
from ...message import ParameterMessageBase
from ...server.aggregation_server import AggregationServer
from ...topology.quantized_endpoint import QuantServerEndpoint
from ...utils.logging import get_logger
from .driver import ObdRoundDriver


class FedOBDServer(AggregationServer):
    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("algorithm", FedAVGAlgorithm())
        super().__init__(**kwargs)
        self._driver = ObdRoundDriver.from_config(self.config)
        self._last_phase_name = ""  # phase that produced the pending row
        assert isinstance(self._endpoint, QuantServerEndpoint)
        self._endpoint.quant_broadcast = True

    def _annotate_stat(self, round_stat: dict) -> None:
        if self._last_phase_name:
            round_stat["phase"] = self._last_phase_name

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

    def _stopped(self) -> bool:
        return self._driver.finished
