"""The threaded Shapley values' aggregation (the port's copy of the JAX
package's ``method/shapley_value/shapley_value_algorithm.py``): FedAvg
without accumulation, whose every upload is a row of the ``[W, D]`` f32
stack (``algorithm/fed_avg_algorithm.py``).

At the round's aggregate the engine (``shapley/``; built in round 1 with
the round's players, round 0's test accuracy as ``last_round_metric`` and
``sv_engine_kwargs``) asks for subset metrics, which
``parallel/spmd_shapley.py::SubsetMetrics`` computes as it does for the
SPMD session: kernel K1 once a subset over the stack with the dataset sizes
under the subset's mask, summed first, then the test accuracy.  Under
``choose_best_subset`` the round's aggregate takes only the rows of its
best subset (the keys of ``shapley_values_S[round]``).  On exit
``shapley_values.json`` (and, under ``choose_best_subset``,
``shapley_values_S.json``) are written under ``save_dir``, round -> {worker
id: value}; the worker ids are ``int`` at every level.
"""

import os

import numpy as np

from ... import shapley
from ...algorithm.fed_avg_algorithm import FedAVGAlgorithm
from ...engine.batching import stage_batches
from ...message import Message
from ...ml_type import MachineLearningPhase as Phase
from ...parallel.spmd_shapley import SubsetMetrics
from ...util.checkpoint import atomic_json_dump
from ...utils.logging import get_logger


class ShapleyValueAlgorithm(FedAVGAlgorithm):
    accumulate = False
    metric_type = "accuracy"

    def __init__(self, sv_algorithm_cls: type, hierarchical: bool = False, server=None) -> None:
        super().__init__(server=server)
        self.sv_algorithm_cls = sv_algorithm_cls
        self.hierarchical = hierarchical
        self.sv_algorithm = None
        self.shapley_values: dict[int, dict] = {}
        self.shapley_values_S: dict[int, dict] = {}
        self._subsets: SubsetMetrics | None = None
        self._best_subset: set[int] = set()

    @property
    def config(self):
        return self._server.config

    @property
    def choose_best_subset(self) -> bool:
        return bool(self.config.algorithm_kwargs.get("choose_best_subset", False))

    @property
    def subsets(self) -> SubsetMetrics:
        """The subset evaluator, over the server's test split."""
        if self._subsets is None:
            tester = self._server.tester
            self._subsets = SubsetMetrics(
                tester.engine,
                tester.dataset_collection.get_dataset(Phase.Test),
                lambda host: stage_batches(host, tester.model_ctx.compute_dtype, tester.device),
            )
        return self._subsets

    def aggregate_worker_data(self) -> Message:
        round_number = self._server.round_number
        if self.sv_algorithm is None:
            assert round_number == 1
            self.sv_algorithm = self.sv_algorithm_cls(
                players=sorted(self._all_worker_data),
                last_round_metric=self._server.performance_stat[round_number - 1][f"test_{self.metric_type}"],
                **shapley.sv_engine_kwargs(self.config, hierarchical=self.hierarchical),
            )
        metric_many = self.subsets.metric_many(self.stack, self.stack_sizes, round_number)
        self.sv_algorithm.set_metric_function(lambda subset: metric_many([subset])[0])
        self.sv_algorithm.set_batch_metric_function(metric_many)
        self.subsets.round_subsets[round_number] = 0
        self.sv_algorithm.compute(round_number=round_number)
        for record, source in (
            (self.shapley_values, self.sv_algorithm.shapley_values),
            (self.shapley_values_S, self.sv_algorithm.shapley_values_S),
        ):
            record[round_number] = {int(w): sv for w, sv in source[round_number].items()}
        self._best_subset = set()
        if self.choose_best_subset and self.shapley_values_S[round_number]:
            self._best_subset = set(self.shapley_values_S[round_number])
            get_logger().info("use subset %s", sorted(self._best_subset))
        return super().aggregate_worker_data()

    @property
    def aggregate_mask(self) -> np.ndarray:
        mask = super().aggregate_mask
        if self._best_subset:
            keep = np.zeros_like(mask)
            keep[sorted(self._best_subset)] = 1.0
            mask *= keep
        return mask

    def exit(self) -> None:
        if self.sv_algorithm is None:
            return
        records = [("shapley_values.json", self.shapley_values)]
        if self.choose_best_subset:
            records.append(("shapley_values_S.json", self.shapley_values_S))
        for name, record in records:
            atomic_json_dump(os.path.join(self.config.save_dir, name), {str(k): v for k, v in record.items()})
