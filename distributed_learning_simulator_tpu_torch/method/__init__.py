"""Federated methods of the threaded executor; importing the package
registers them with :class:`~.algorithm_factory.CentralizedAlgorithmFactory`."""

from . import fed_avg, fed_dropout_avg, fed_obd, fed_paq, sign_sgd, smafd  # noqa: F401  (registration)
