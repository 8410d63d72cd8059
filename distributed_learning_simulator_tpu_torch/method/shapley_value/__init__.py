"""The Shapley-value methods on the threaded executor: GTG, multi-round and
hierarchical.  Their workers are FedAvg's, training the trainer's own
per-epoch stream (shuffled batches from ``seed * 100003 + epoch``), as
the JAX package's roles do."""

from ...worker.aggregation_worker import AggregationWorker
from ..algorithm_factory import CentralizedAlgorithmFactory
from .servers import GTGShapleyValueServer, HierarchicalShapleyValueServer, MultiRoundShapleyValueServer


class ShapleyValueWorker(AggregationWorker):
    def _aligned_stream(self) -> bool:
        return False


for _name, _server in (
    ("multiround_shapley_value", MultiRoundShapleyValueServer),
    ("GTG_shapley_value", GTGShapleyValueServer),
    ("Hierarchical_shapley_value", HierarchicalShapleyValueServer),
):
    CentralizedAlgorithmFactory.register_algorithm(algorithm_name=_name, client_cls=ShapleyValueWorker, server_cls=_server)
