"""sign-SGD on the threaded executor: each optimizer step's gradient
signs, voted by majority on the server (the port's copy of the JAX
package's ``method/sign_sgd``)."""

from ..algorithm_factory import CentralizedAlgorithmFactory
from .server import GradientServer, SignSGDAlgorithm
from .worker import SignSGDWorker

CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="sign_SGD",
    client_cls=SignSGDWorker,
    server_cls=GradientServer,
    algorithm_cls=SignSGDAlgorithm,
)
