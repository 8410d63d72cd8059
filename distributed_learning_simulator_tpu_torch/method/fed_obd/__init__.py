"""FedOBD on the threaded executor: two-phase opportunistic block dropout
over a quantized transport, NNADQ for ``fed_obd`` and QSGD for
``fed_obd_sq`` (the port's copy of the JAX package's ``method/fed_obd``)."""

from ...topology.quantized_endpoint import (
    NNADQClientEndpoint,
    NNADQServerEndpoint,
    StochasticQuantClientEndpoint,
    StochasticQuantServerEndpoint,
)
from ..algorithm_factory import CentralizedAlgorithmFactory
from .server import FedOBDServer
from .worker import FedOBDWorker

CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_obd",
    client_cls=FedOBDWorker,
    server_cls=FedOBDServer,
    client_endpoint_cls=NNADQClientEndpoint,
    server_endpoint_cls=NNADQServerEndpoint,
)

CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_obd_sq",
    client_cls=FedOBDWorker,
    server_cls=FedOBDServer,
    client_endpoint_cls=StochasticQuantClientEndpoint,
    server_endpoint_cls=StochasticQuantServerEndpoint,
)
