"""fed_aas on the threaded executor: a :class:`GraphWorker` that trains on
its local subgraph only (no boundary exchange) and, when ``num_neighbor``
is set (``algorithm_kwargs``, else ``extra_hyper_parameters``), caps the
fan-in of its in-client edges anew every round from ``default_rng(seed *
1013 + worker_id * 97 + round)`` (``ops/graph_sampling.py::cap_fan_in``),
as the JAX package's ``FedAASWorker``."""

import numpy as np

from ...ops.graph_sampling import cap_fan_in
from ...server.graph_server import GraphNodeServer
from ...utils.logging import get_logger
from ...worker.graph_worker import GraphWorker
from ..algorithm_factory import CentralizedAlgorithmFactory


class FedAASWorker(GraphWorker):
    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self._share_feature = False
        # resampled a round here, not a batch by the data loader
        self._dataloader_num_neighbor = False
        self._num_neighbor = self.config.algorithm_kwargs.get(
            "num_neighbor", self.config.extra_hyper_parameters.get("num_neighbor")
        )

    def _before_round(self) -> None:
        super()._before_round()
        if self._num_neighbor is None:
            return
        graph = self.training_dataset.inputs
        base = self._local_edge_mask.astype(bool)
        rng = np.random.default_rng(self.config.seed * 1013 + self.worker_id * 97 + self._round_num)
        keep = cap_fan_in(base, graph["edge_index"][1], int(self._num_neighbor), rng)
        graph["edge_mask"] = keep.astype(np.float32)
        get_logger().debug(
            "%s round %d: neighbor sampling kept %d/%d local edges",
            self.name, self._round_num, int(keep.sum()), int(base.sum()),
        )


CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_aas", client_cls=FedAASWorker, server_cls=GraphNodeServer
)
