"""FedAvg with delta uploads on the threaded executor."""

from ...algorithm.fed_avg_algorithm import FedAVGAlgorithm
from ...server.aggregation_server import AggregationServer
from ...worker.aggregation_worker import AggregationWorker
from ..algorithm_factory import CentralizedAlgorithmFactory

CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_avg",
    client_cls=AggregationWorker,
    server_cls=AggregationServer,
    algorithm_cls=FedAVGAlgorithm,
)
