"""The threaded Shapley servers (the port's copy of the JAX package's
``method/shapley_value/servers.py``): each records the initial model's
metric as round 0 (``need_init_performance``) for its engine."""

from typing import Any

from ...server.aggregation_server import AggregationServer
from ...shapley import GTGShapleyValue, HierarchicalShapleyValue, MultiRoundShapleyValue
from .shapley_value_algorithm import ShapleyValueAlgorithm


class ShapleyValueServer(AggregationServer):
    #: subset sampling needs every upload of a round
    _buffered_capable = False
    sv_algorithm_cls: type
    hierarchical = False

    def __init__(self, **kwargs: Any) -> None:
        algorithm = ShapleyValueAlgorithm(self.sv_algorithm_cls, hierarchical=self.hierarchical, server=self)
        super().__init__(**kwargs, algorithm=algorithm)
        self.need_init_performance = True

    def _annotate_stat(self, round_stat: dict) -> None:
        """A round's subsets evaluated and their seconds, as the SPMD
        session records them (not on round 0's row)."""
        subsets = self.algorithm.subsets
        if self.round_number in subsets.round_subsets:
            round_stat["subsets"] = subsets.round_subsets[self.round_number]
            round_stat["subset_seconds"] = subsets.subset_seconds.get(self.round_number, 0.0)


class GTGShapleyValueServer(ShapleyValueServer):
    sv_algorithm_cls = GTGShapleyValue


class MultiRoundShapleyValueServer(ShapleyValueServer):
    sv_algorithm_cls = MultiRoundShapleyValue


class HierarchicalShapleyValueServer(ShapleyValueServer):
    """Two-level values over worker groups (``part_number``, ``vp_size``
    in ``algorithm_kwargs``)."""

    sv_algorithm_cls = HierarchicalShapleyValue
    hierarchical = True
