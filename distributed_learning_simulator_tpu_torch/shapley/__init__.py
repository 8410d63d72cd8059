from .gtg_shapley_value import GTGShapleyValue
from .hierarchical_shapley_value import HierarchicalShapleyValue
from .multiround_shapley_value import MultiRoundShapleyValue

#: hierarchical grouping knobs that live directly in ``algorithm_kwargs``
#: (``conf/hierarchical_sv/mnist.yaml``) rather than under ``sv_kwargs``
HIERARCHICAL_CONFIG_KEYS = ("part_number", "vp_size")


def sv_engine_kwargs(config, hierarchical: bool) -> dict:
    """Engine ctor kwargs beyond (players, last_round_metric) — the ONE
    definition shared by the threaded servers and the SPMD session, so both
    executors construct identically-configured engines."""
    kwargs = dict(config.algorithm_kwargs.get("sv_kwargs", {}))
    if hierarchical:
        for key in HIERARCHICAL_CONFIG_KEYS:
            if key in config.algorithm_kwargs:
                kwargs[key] = config.algorithm_kwargs[key]
    return kwargs


__all__ = [
    "GTGShapleyValue",
    "HierarchicalShapleyValue",
    "MultiRoundShapleyValue",
    "sv_engine_kwargs",
]
