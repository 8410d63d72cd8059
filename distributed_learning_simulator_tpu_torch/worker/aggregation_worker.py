"""The FedAvg client (the port's copy of the JAX package's
``worker/aggregation_worker.py``): registers its aggregation at a hook
point (the end of local training by default), uploads a parameter delta
(or the parameters, or the best validation epoch's), waits for the
aggregate, answers an unselected round's ``None`` with ``None``, and
mirrors the global model in a :class:`ModelCache`.  A round trains the
SPMD session's stream unless the role says otherwise
(:meth:`AggregationWorker._aligned_stream`), and the upload of a round
armed so hands its reserved
:class:`~..ops.quantization.SessionKey` to an endpoint that takes one
(``set_quant_key``): the two executors then draw the same codec values.

The fault plan acts at the upload (:meth:`AggregationWorker._inject_upload_faults`):
a straggling worker sleeps its own seeded delay, a dropped one sends
``None`` and waits for the round's result as a worker that uploaded, and a
corrupt one NaN-fills its upload for the server's guard.  A resumed
server's initial broadcast carries its round, and the worker jumps
there; a worker it leaves out gets the round in a bare ``Message`` and
then answers as to ``None``."""

import os
from typing import Any

from ..engine.engine import summarize_metrics
from ..message import DeltaParameterMessage, Message, ParameterMessage, ParameterMessageBase
from ..ml_type import ExecutorHookPoint, MachineLearningPhase, StopExecutingException
from ..util.faults import FaultPlan
from ..util.model_cache import ModelCache
from ..utils.logging import get_logger
from .client import Client


class KeepModelHook:
    """Keeps the parameters of the epoch with the best validation accuracy
    (a later epoch wins ties)."""

    def __init__(self) -> None:
        self.best_model: dict[str, Any] | None = None

    def __call__(self, executor, hook_point, **kwargs) -> None:
        trainer = executor
        if not trainer.dataset_collection.has_dataset(MachineLearningPhase.Validation):
            return
        batches, _ = trainer.epoch_batches(MachineLearningPhase.Validation, None)
        metrics = summarize_metrics(trainer.engine.evaluate(trainer.params, batches))
        if self.best_model is None or metrics["accuracy"] >= self.best_model["accuracy"]:
            self.best_model = {"parameter": trainer.get_parameter_dict(), "accuracy": metrics["accuracy"]}

    def clear(self) -> None:
        self.best_model = None


class AggregationWorker(Client):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._aggregation_time: ExecutorHookPoint = ExecutorHookPoint.AFTER_EXECUTE
        self._reuse_learning_rate = False
        self._choose_model_by_validation = False
        self._send_parameter_diff = True
        self._model_cache = ModelCache()
        self._keep_model_hook: KeepModelHook | None = None
        # the seeded draws the SPMD sessions fold into their weight rows
        self._fault_plan = FaultPlan.from_config(self.config)

    def _before_training(self) -> None:
        super()._before_training()
        dc = self.trainer.dataset_collection
        dc.remove_dataset(phase=MachineLearningPhase.Test)
        if self.config.dataset_sampling == "iid":
            self.enable_choose_model_by_validation()
        if not self._choose_model_by_validation:
            dc.remove_dataset(phase=MachineLearningPhase.Validation)
        if self.config.distribute_init_parameters:
            try:
                self._get_result_from_server()
            except StopExecutingException:
                return
            if self._stopped():
                return
        self._register_aggregation()

    def _aligned_stream(self) -> bool:
        """Whether this round trains the SPMD session's stream for (seed,
        round, worker), which pins the two executors to one trajectory
        and reserves the round's codec key; a role that keeps the
        trainer's own per-epoch stream returns False."""
        return True

    def _quant_fold_indices(self) -> dict[str, int] | None:
        """Each coded leaf's position in the whole parameter dict, for a
        worker that codes a subset of the leaves (None: every leaf)."""
        return None

    def _before_round(self) -> None:
        super()._before_round()
        if self._aligned_stream():
            self.trainer.set_round_stream((self.config.seed, self._round_num, self.worker_id))

    def _register_aggregation(self) -> None:
        self.trainer.remove_named_hook(name="aggregation")

        def aggregation_impl(**kwargs) -> None:
            self._aggregation(sent_data=self._get_sent_data(), **kwargs)

        self.trainer.append_named_hook(self._aggregation_time, "aggregation", aggregation_impl)

    def _inject_upload_faults(self, sent_data: Message) -> Message | None:
        """The round's fault plan at the upload: a straggler sleeps, a
        dropped upload becomes ``None`` (the worker trained, the upload was
        lost), a corrupt one is NaN-poisoned.  Returns what to send."""
        plan = self._fault_plan
        if plan is None or not plan.injection_active:
            return sent_data
        n, round_number = self.config.worker_number, self._round_num
        plan.straggler_sleep(round_number, n, worker_id=self.worker_id)
        if self.worker_id in plan.dropped_clients(round_number, n):
            get_logger().warning("fault plan: worker %s drops round %s upload", self.worker_id, round_number)
            return None
        if self.worker_id in plan.corrupt_clients(round_number, n):
            get_logger().warning("fault plan: worker %s corrupts round %s upload", self.worker_id, round_number)
            match sent_data:
                case DeltaParameterMessage():
                    plan.poison_params(sent_data.delta_parameter)
                case ParameterMessage():
                    plan.poison_params(sent_data.parameter)
        return sent_data

    def _aggregation(self, sent_data: Message, **kwargs: Any) -> None:
        sent_data = self._inject_upload_faults(sent_data)
        if sent_data is None:  # a lost upload: stay in step with the server
            self.send_data_to_server(None)
            self._get_result_from_server()
            return
        key = self.trainer.reserved_quant_key
        if key is not None and hasattr(self._endpoint, "set_quant_key"):
            self._endpoint.set_quant_key(key, fold_indices=self._quant_fold_indices())
        self.send_data_to_server(sent_data)
        self._offload_from_device()
        self._get_result_from_server()

    def enable_choose_model_by_validation(self) -> None:
        dc = self.trainer.dataset_collection
        if not dc.has_dataset(MachineLearningPhase.Validation) or dc.dataset_size(
            MachineLearningPhase.Validation
        ) == 0:
            return  # small splits can leave a worker no validation samples
        self._choose_model_by_validation = True
        if self._keep_model_hook is None:
            self._keep_model_hook = KeepModelHook()
            self.trainer.append_named_hook(
                ExecutorHookPoint.AFTER_EPOCH, "keep_model_hook", self._keep_model_hook
            )

    def disable_choose_model_by_validation(self) -> None:
        self._choose_model_by_validation = False
        if self._keep_model_hook is not None:
            self.trainer.remove_named_hook("keep_model_hook")
            self._keep_model_hook = None

    def _get_sent_data(self) -> ParameterMessageBase:
        hook = self._keep_model_hook
        if self._choose_model_by_validation and hook is not None and hook.best_model is not None:
            parameter = hook.best_model["parameter"]
        else:
            parameter = self.trainer.get_parameter_dict()
        if self._send_parameter_diff:
            return DeltaParameterMessage(
                dataset_size=self.trainer.dataset_size,
                delta_parameter=self._model_cache.get_parameter_diff(parameter),
            )
        return ParameterMessage(dataset_size=self.trainer.dataset_size, parameter=parameter)

    def _load_result_from_server(self, result: Message) -> None:
        if result.end_training:
            self._force_stop = True
            raise StopExecutingException()
        if getattr(result, "is_initial", False) and "round" in result.other_data:
            self._round_num = result.other_data["round"]  # the server resumed: jump to its round
        model_path = os.path.join(self.config.save_dir, "aggregated_model", f"round_{self._round_num}.npz")
        match result:
            case ParameterMessage():
                self._model_cache.cache_parameter_dict(result.parameter, path=model_path)
            case DeltaParameterMessage():
                self._model_cache.add_parameter_diff(result.delta_parameter, path=model_path)
            case _:
                raise NotImplementedError(type(result))
        self.trainer.load_parameter_dict(
            self._model_cache.parameter_dict, reuse_learning_rate=self._reuse_learning_rate
        )

    def _offload_from_device(self) -> None:
        if self.config.limited_resource:
            self._model_cache.save()
        if self._keep_model_hook is not None:
            self._keep_model_hook.clear()
        super()._offload_from_device()

    def _get_result_from_server(self) -> None:
        """Blocking receive; a ``None`` means unselected this round: advance
        the round, answer ``None`` and wait again."""
        while True:
            result = self._get_data_from_server()
            if type(result) is Message and "round" in result.other_data:
                # left out of a resumed run's initial broadcast: its round, then as None
                self._round_num = result.other_data["round"]
                result = None
            if result is None:
                get_logger().debug("%s skips round %s", self.name, self._round_num)
                self._round_num += 1
                self.send_data_to_server(None)
                if self._stopped():
                    return
                continue
            self._load_result_from_server(result=result)
            break
