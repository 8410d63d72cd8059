"""single_model_afd on the threaded executor: error-feedback sparsified
delta uploads (the port's copy of the JAX package's ``method/smafd``)."""

from ...algorithm.fed_avg_algorithm import FedAVGAlgorithm
from ...server.aggregation_server import AggregationServer
from ..algorithm_factory import CentralizedAlgorithmFactory
from .worker import SingleModelAFDWorker

CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="single_model_afd",
    client_cls=SingleModelAFDWorker,
    server_cls=AggregationServer,
    algorithm_cls=FedAVGAlgorithm,
)
