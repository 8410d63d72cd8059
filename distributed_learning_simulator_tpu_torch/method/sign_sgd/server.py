"""The per-step gradient server (the port's copy of the JAX package's
``method/sign_sgd/server.py``): it gathers every running worker's
gradient message of an optimizer step, aggregates them (sign-SGD: the
majority vote ``sign(sum of the signs)``, stacked in worker order, in
plain PyTorch on the device, as the JAX package's is plain XLA) and sends
the result ``in_round`` to the running workers.  A worker's
``end_training`` retires it for good: later steps aggregate over the
workers still running, and the loop stops once all have retired.  At exit
the last final parameters are evaluated on the test split and written as
round 1 of ``server/round_record.json``."""

import os
from typing import Any

import torch

from ...algorithm.aggregation_algorithm import AggregationAlgorithm
from ...message import Message, ParameterMessage
from ...server.server import Server
from ...util.checkpoint import atomic_json_dump
from ...utils.logging import get_logger


class SignSGDAlgorithm(AggregationAlgorithm):
    """Majority vote: the sign of the sum of the workers' signs."""

    def aggregate_worker_data(self) -> Message:
        gradients = [
            data.other_data["gradient"]
            for _, data in sorted(self._all_worker_data.items())
            if "gradient" in data.other_data
        ]
        if not gradients:
            return Message(end_training=True)
        return Message(in_round=True, other_data={"gradient": torch.sign(torch.stack(gradients).sum(0))})


class GradientServer(Server):
    #: the JAX gradient server reads no fault plan, quorum, resume or buffer
    _takes_fault_plan = False

    def __init__(self, algorithm: AggregationAlgorithm, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._algorithm = algorithm
        self._algorithm.set_server(self)
        self._algorithm.set_config(self.config)
        self._worker_flag: set[int] = set()
        self._ended: set[int] = set()
        self._end = False
        self._final_params = None
        self._stat: dict[int, dict] = {}

    @property
    def algorithm(self) -> AggregationAlgorithm:
        return self._algorithm

    @property
    def performance_stat(self) -> dict[int, dict]:
        return self._stat

    def _process_worker_data(self, worker_id: int, data: Message | None) -> None:
        if data is not None and data.end_training:
            self._ended.add(worker_id)
            if isinstance(data, ParameterMessage) and data.parameter:
                self._final_params = data.parameter
            if len(self._ended) >= self.worker_number:
                self._end = True
                get_logger().info("all workers ended; gradient server stops")
        else:
            self._algorithm.process_worker_data(worker_id=worker_id, worker_data=data)
            self._worker_flag.add(worker_id)
        self._maybe_aggregate()

    def _maybe_aggregate(self) -> None:
        expected = self.worker_number - len(self._ended)
        if expected == 0 or len(self._worker_flag) < expected:
            return
        result = self._algorithm.aggregate_worker_data()
        if result.end_training:
            self._end = True
        else:
            self._send_result(result)
        self._worker_flag.clear()
        self._algorithm.clear_worker_data()

    def _active_workers(self) -> set[int]:
        return set(range(self.worker_number)) - self._ended

    def _select_workers(self) -> set[int]:
        return self._active_workers()  # every step reaches every running worker

    def _stopped(self) -> bool:
        return self._end

    def _server_exit(self) -> None:
        if self._final_params is not None:
            metric = self.get_metric(self._final_params)
            self._stat[1] = {f"test_{k}": v for k, v in metric.items()}
            atomic_json_dump(os.path.join(self.save_dir, "round_record.json"), self._stat)
        self._algorithm.exit()
