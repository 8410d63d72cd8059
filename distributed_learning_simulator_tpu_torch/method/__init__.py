"""Federated methods of the threaded executor; importing the package
registers them with :class:`~.algorithm_factory.CentralizedAlgorithmFactory`."""

from . import (  # noqa: F401  (registration)
    fed_aas,
    fed_avg,
    fed_dropout_avg,
    fed_gnn,
    fed_obd,
    fed_paq,
    shapley_value,
    sign_sgd,
    smafd,
)
