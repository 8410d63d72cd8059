"""FedPAQ on the threaded executor: FedAvg over the QSGD transport (the
port's copy of the JAX package's ``method/fed_paq``).  Each round's upload
is keyed with the FedAvg session's fed_paq draws for that client
(``worker/aggregation_worker.py``)."""

from ...algorithm.fed_avg_algorithm import FedAVGAlgorithm
from ...server.aggregation_server import AggregationServer
from ...topology.quantized_endpoint import StochasticQuantClientEndpoint, StochasticQuantServerEndpoint
from ...worker.aggregation_worker import AggregationWorker
from ..algorithm_factory import CentralizedAlgorithmFactory

CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_paq",
    client_cls=AggregationWorker,
    server_cls=AggregationServer,
    algorithm_cls=FedAVGAlgorithm,
    client_endpoint_cls=StochasticQuantClientEndpoint,
    server_endpoint_cls=StochasticQuantServerEndpoint,
)
