"""FedOBD client role (the port's copy of the JAX package's
``method/fed_obd/worker.py``): it applies whatever phase spec the
server's annotation names (``driver.py``) and holds no transition rule of
its own.  Phase 1 uploads the kept blocks as diffs against the cached
global model through the quantized endpoint; phase 2 aggregates every
epoch, reusing the learning-rate state, for ``second_phase_epoch`` epochs
and announces ``end_training`` on its last.

One difference from the JAX package: a worker stops on its round counter
only in phase 2.  The JAX worker stops as soon as the counter passes
``config.round``, so a worker left unselected in the last phase-1 round
(``random_client_number < worker_number``) has stopped before the server
broadcasts the switch into phase 2 to every worker, and the server waits
for its uploads forever.  Here such a worker waits for that broadcast and
joins phase 2; every other message flow is the JAX package's.

With ``second_phase_epoch == 1`` the worker's round counter counts
aggregates in both phases, and each round trains the FedOBD session's
stream for ``(seed, aggregate, worker)`` (``parallel/spmd_obd.py``: its
dropout generator and sampler-order batches) and keys its QSGD upload
with that aggregate's session draws, each kept leaf folded by its position
in the whole parameter dict.  The JAX package replays its session's
threefry chain, whose split prefixes depend on the session's padded slot
count; the port's draws are keyed by the integers alone, so nothing of
that carries over.  A longer phase 2 keeps the trainer's own stream, as
in JAX.
"""

from typing import Any

from ...message import DeltaParameterMessage, Message, ParameterMessage
from ...ml_type import ExecutorHookPoint
from ...models.convert import jax_positions
from ...topology.quantized_endpoint import QuantClientEndpoint
from ...utils.logging import get_logger
from ...worker.aggregation_worker import AggregationWorker
from .driver import BLOCK_DROPOUT_ROUNDS, EPOCH_TUNE, PHASE_TWO_KEY, PhaseSpec
from .obd_algorithm import OpportunisticBlockDropoutAlgorithm


class FedOBDWorker(AggregationWorker):
    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._block_selector = OpportunisticBlockDropoutAlgorithm(
            dropout_rate=self.config.algorithm_kwargs["dropout_rate"],
            worker_id=self.worker_id,
        )
        self._spec: PhaseSpec = BLOCK_DROPOUT_ROUNDS
        self._last_epoch_announced = False
        assert isinstance(self._endpoint, QuantClientEndpoint)
        self._endpoint.dequant_server_data = True
        self._apply_spec(self._spec)
        layout = self.trainer.engine.layout
        self._fold_indices = jax_positions(layout.keys, layout.shapes)

    @property
    def block_selector(self) -> OpportunisticBlockDropoutAlgorithm:
        return self._block_selector

    def _apply_spec(self, spec: PhaseSpec) -> None:
        self._spec = spec
        self._send_parameter_diff = not spec.block_dropout
        self._reuse_learning_rate = spec.reuse_learning_rate
        if spec.epoch_cadence:
            self._aggregation_time = ExecutorHookPoint.AFTER_EPOCH

    def _enter_epoch_tune(self) -> None:
        get_logger().info("%s switches to %s", self.name, EPOCH_TUNE.name)
        self._apply_spec(EPOCH_TUNE)
        self.disable_choose_model_by_validation()
        self.trainer.hyper_parameter.epoch = self.config.algorithm_kwargs["second_phase_epoch"]
        # one more round of the worker loop runs the whole tuning phase
        self.config.round = self._round_num + 1
        self._register_aggregation()

    def _aligned_stream(self) -> bool:
        return int(self.config.algorithm_kwargs.get("second_phase_epoch", 0)) == 1

    def _quant_fold_indices(self) -> dict[str, int]:
        return self._fold_indices

    def _load_result_from_server(self, result: Message) -> None:
        if PHASE_TWO_KEY in result.other_data:
            assert isinstance(result, ParameterMessage)
            if result.is_initial and "round" in result.other_data:
                # a resume into phase 2: the round first, as the tuning
                # phase's round budget counts from it
                self._round_num = result.other_data["round"]
            self._enter_epoch_tune()
        super()._load_result_from_server(result=result)

    def _get_sent_data(self) -> Message:
        data = super()._get_sent_data()
        if self._spec.block_dropout:
            assert isinstance(data, ParameterMessage)
            kept = self._block_selector.get_block_parameter(
                parameter_dict=data.parameter, model_cache=self._model_cache
            )
            cached = self._model_cache.parameter_dict
            return DeltaParameterMessage(
                delta_parameter={k: v - cached[k] for k, v in kept.items()},
                dataset_size=data.dataset_size,
                other_data=data.other_data,
                in_round=data.in_round,
                end_training=data.end_training,
            )
        data.in_round = True
        if self._spec.check_acc:
            data.other_data["check_acc"] = True
        return data

    def _aggregation(self, sent_data: Message, **kwargs: Any) -> None:
        if self._spec.epoch_cadence and kwargs["epoch"] == kwargs["executor"].hyper_parameter.epoch:
            sent_data.end_training = True  # the last tuning epoch ends the run
            self._last_epoch_announced = True
        super()._aggregation(sent_data=sent_data, **kwargs)

    def _stopped(self) -> bool:
        if self._last_epoch_announced or self._force_stop:
            return True
        return self._spec.epoch_cadence and super()._stopped()
