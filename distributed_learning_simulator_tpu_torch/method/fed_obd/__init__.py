"""FedOBD over QSGD transport (``fed_obd_sq``): two-phase opportunistic
block dropout.  ``fed_obd`` (NNADQ transport) is not ported yet."""

from ...topology.quantized_endpoint import StochasticQuantClientEndpoint, StochasticQuantServerEndpoint
from ..algorithm_factory import CentralizedAlgorithmFactory
from .server import FedOBDServer
from .worker import FedOBDWorker

CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_obd_sq",
    client_cls=FedOBDWorker,
    server_cls=FedOBDServer,
    client_endpoint_cls=StochasticQuantClientEndpoint,
    server_endpoint_cls=StochasticQuantServerEndpoint,
)
