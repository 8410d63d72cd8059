"""Federated methods of the threaded executor; importing the package
registers them with :class:`~.algorithm_factory.CentralizedAlgorithmFactory`."""

from . import fed_avg, fed_obd  # noqa: F401  (registration)
