"""The round state machine over an aggregation algorithm (the port's copy
of the JAX package's ``server/aggregation_server.py``, synchronous rounds
only): send the initial model, gather every worker's message each round,
aggregate, evaluate the aggregate on the test split, append a row to
``server/round_record.json`` and save ``aggregated_model/round_N.npz`` in
the JAX package's keys and layouts.  With ``need_init_performance`` (the
Shapley servers) the initial model is evaluated and recorded as round 0.
Buffered aggregation, resume, the population store and the fault plan
are refused (``training.py``); a server whose ``_buffered_capable`` is
False raises the JAX package's ``ValueError`` on ``aggregation_mode:
buffered``.

Telemetry (``util/telemetry.py``) speaks the SPMD sessions' schema, as the
JAX server does: an ``upload`` event a worker message, a ``round_barrier``
span (first upload to the last worker in), and a ``round`` span a record
row (its offset the row's ``trace_offset``; ``init_eval`` for round 0's
row), all on the server thread
from host state it owns.  The ``profile_rounds`` window opens at the first
upload of its first round and closes after its last round's record.  The
server loop closes the recorder only on its clean path, so each record is
flushed as it is made unless ``telemetry.flush_every`` says otherwise."""

import os
import time
from typing import Any

import numpy as np

from ..algorithm.aggregation_algorithm import AggregationAlgorithm
from ..message import Message, ParameterMessage, ParameterMessageBase, Params
from ..models.convert import from_jax, to_jax
from ..util.buffered import BufferedSettings
from ..util.checkpoint import atomic_json_dump
from ..util.model_cache import ModelCache
from ..util.telemetry import TraceRecorder
from ..utils.logging import get_logger
from .server import Server


class AggregationServer(Server):
    #: whether the server could run ``aggregation_mode: buffered``: the
    #: servers that own their rounds (Shapley sampling, the graph
    #: exchanges) refuse the knob with the JAX package's ValueError
    _buffered_capable = True

    def __init__(self, algorithm: AggregationAlgorithm, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if BufferedSettings.from_config(self.config) is not None and not self._buffered_capable:
            raise ValueError(
                "algorithm_kwargs.aggregation_mode=buffered is unsupported here:"
                f" {type(self).__name__} owns its own round/phase progression — drop the knob for this server"
            )
        self._model_cache = ModelCache()
        self._round_number = 1
        self._worker_flag: set[int] = set()
        self.__algorithm = algorithm
        self.__algorithm.set_server(self)
        self.__algorithm.set_config(self.config)
        self.__stat: dict[int, dict] = {}
        self._compute_stat = True
        self.need_init_performance = False
        self.__plateau = 0
        self.__best_acc = 0.0
        self.__max_acc = 0.0
        self.__early_stop = self.config.algorithm_kwargs.get("early_stop", False)
        self.__round_start = time.monotonic()
        self.__round_start_bytes = (0, 0)
        device = getattr(getattr(self._task_context, "model_ctx", None), "device", None)
        self._trace = TraceRecorder.from_config(self.config, default_dir=self.save_dir, device=device)
        if not (self.config.telemetry or {}).get("flush_every"):
            # no try/finally wraps the server loop: flush every record, as
            # the record itself is written every round (an explicit 0 means
            # "auto" and gets the same eager default)
            self._trace.flush_every = 1
        self._upload_window_start: float | None = None

    @property
    def early_stop(self) -> bool:
        return self.__early_stop

    @property
    def algorithm(self) -> AggregationAlgorithm:
        return self.__algorithm

    @property
    def round_number(self) -> int:
        return self._round_number

    @property
    def performance_stat(self) -> dict[int, dict]:
        return self.__stat

    def _get_init_model(self) -> Params:
        init_path = self.config.algorithm_kwargs.get("global_model_path")
        if init_path:
            with np.load(init_path) as blob:
                params = from_jax({k: blob[k] for k in blob.files})
            return {k: v.to(self.tester.device) for k, v in params.items()}
        return self.tester.get_parameter_dict()

    def _before_start(self) -> None:
        if self.config.distribute_init_parameters:
            self._send_result(
                ParameterMessage(
                    in_round=True,
                    parameter=self._get_init_model(),
                    other_data={"init": True},
                    is_initial=True,
                )
            )

    def _server_exit(self) -> None:
        self.__algorithm.exit()
        self._trace.close()

    def _process_worker_data(self, worker_id: int, data: Message | None) -> None:
        assert 0 <= worker_id < self.worker_number
        self._trace.maybe_profile_start(self._round_number)
        if self._trace.enabled:
            if not self._worker_flag:
                # the barrier opens at the round's first upload
                self._upload_window_start = time.monotonic()
            self._trace.event("upload", worker=worker_id, round=self._round_number, dropped=data is None)
        self.__algorithm.process_worker_data(
            worker_id=worker_id,
            worker_data=data,
            old_parameter_dict=self._model_cache.parameter_dict,
        )
        self._worker_flag.add(worker_id)
        if len(self._worker_flag) == self.worker_number:
            if self._trace.enabled and self._upload_window_start is not None:
                self._trace.span_record(
                    "round_barrier",
                    time.monotonic() - self._upload_window_start,
                    round=self._round_number,
                    workers=self.worker_number,
                )
                self._upload_window_start = None
            result = self._aggregate_worker_data()
            self._send_result(result)
            self._worker_flag.clear()

    def _aggregate_worker_data(self) -> Message:
        return self.__algorithm.aggregate_worker_data()

    def _before_send_result(self, result: Message) -> None:
        if not isinstance(result, ParameterMessageBase):
            return
        assert isinstance(result, ParameterMessage)
        initial = "init" in result.other_data
        if self.need_init_performance and initial:
            # the row keyed 0 (the Shapley engines' round-0 metric)
            self.__record_compute_stat(result.parameter, keep_performance_logger=False, stat_key=0)
        elif self._compute_stat and not initial:
            self.__record_compute_stat(result.parameter)
            self._maybe_early_stop(result)
        elif result.end_training and not initial:
            self.__record_compute_stat(result.parameter)
        # the checkpoint is keyed by the record row just written (FedOBD's
        # in-round aggregates append rows while the round counter stands)
        recorded_key = max((k for k in self.__stat if k > 0), default=self._round_number)
        model_path = os.path.join(self.config.save_dir, "aggregated_model", f"round_{recorded_key}.npz")
        self._model_cache.cache_parameter_dict(result.parameter, model_path)
        if self.config.checkpoint_every_round:
            every = max(1, int(self.config.checkpoint_every or 1))
            if (
                every == 1
                or recorded_key % every == 0
                or recorded_key >= self.config.round
                or result.end_training
            ):
                self._model_cache.save()

    def _after_send_result(self, result: Message) -> None:
        if isinstance(result, ParameterMessageBase) and not result.in_round:
            self._trace.maybe_profile_stop(self._round_number)
            self._round_number += 1
        self.__algorithm.clear_worker_data()

    def _stopped(self) -> bool:
        return self._round_number > self.config.round

    def _get_stat_key(self) -> int:
        return self._round_number

    def _annotate_stat(self, round_stat: dict) -> None:
        """Subclass hook: extra fields on each round record."""

    def __record_compute_stat(
        self, parameter_dict: Params, keep_performance_logger: bool = True, stat_key: int | None = None
    ) -> None:
        self.tester.set_visualizer_prefix(f"round: {self._round_number},")
        metric = self.get_metric(parameter_dict, keep_performance_logger=keep_performance_logger)
        round_stat = {f"test_{k}": v for k, v in metric.items()}
        now = time.monotonic()
        round_stat["round_seconds"] = now - self.__round_start
        round_stat["received_mb"] = (self.received_bytes - self.__round_start_bytes[0]) / 1e6
        round_stat["sent_mb"] = (self.sent_bytes - self.__round_start_bytes[1]) / 1e6
        self.__round_start = now
        self.__round_start_bytes = (self.received_bytes, self.sent_bytes)
        self._annotate_stat(round_stat)
        key = self._get_stat_key() if stat_key is None else stat_key
        assert key not in self.__stat
        if self._trace.enabled:
            fields = {
                "round": key,
                "accuracy": metric.get("accuracy"),
                "loss": metric.get("loss"),
                "received_mb": round_stat["received_mb"],
                "sent_mb": round_stat["sent_mb"],
            }
            # round 0's row is not a round: a kind of its own
            round_stat["trace_offset"] = self._trace.span_record(
                "round" if key else "init_eval", round_stat["round_seconds"], **fields
            )
        self.__stat[key] = round_stat
        # the spans first, so a durable row never cross-links a line a
        # resumed recorder would number again
        self._trace.flush()
        atomic_json_dump(os.path.join(self.save_dir, "round_record.json"), self.__stat)
        max_acc = max(t["test_accuracy"] for t in self.__stat.values())
        if max_acc > self.__best_acc:
            self.__best_acc = max_acc
            np.savez(os.path.join(self.save_dir, "best_global_model.npz"), **to_jax(parameter_dict))

    def _maybe_early_stop(self, result: Message) -> None:
        """Plateau stop after each recorded round (FedOBD's driver owns its
        own and overrides this)."""
        if not result.end_training and self.early_stop and self._convergent():
            result.end_training = True

    def _convergent(self) -> bool:
        """A 5-round accuracy plateau."""
        max_acc = max(t["test_accuracy"] for t in self.performance_stat.values())
        if max_acc > self.__max_acc + 0.001:
            self.__max_acc = max_acc
            self.__plateau = 0
            return False
        self.__plateau += 1
        get_logger().info("plateau %s (max acc %.4f)", self.__plateau, self.__max_acc)
        return self.__plateau >= 5
