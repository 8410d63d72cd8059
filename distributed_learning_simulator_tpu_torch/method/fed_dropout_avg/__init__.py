"""FedDropoutAvg on the threaded executor: per-element Bernoulli dropout
of the uploaded parameters, aggregated with per-element weights (the port's
copy of the JAX package's ``method/fed_dropout_avg``)."""

from ...server.aggregation_server import AggregationServer
from ..algorithm_factory import CentralizedAlgorithmFactory
from .algorithm import FedDropoutAvgAlgorithm
from .worker import FedDropoutAvgWorker

CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_dropout_avg",
    client_cls=FedDropoutAvgWorker,
    server_cls=AggregationServer,
    algorithm_cls=FedDropoutAvgAlgorithm,
)
