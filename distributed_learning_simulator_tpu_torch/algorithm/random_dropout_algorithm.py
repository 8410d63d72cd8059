"""Random whole-tensor dropout of a parameter dict (the port's copy of the
JAX package's ``algorithm/random_dropout_algorithm.py``): the tensors in
an order shuffled by Python's ``random.Random(seed)``, each kept while the
kept sizes stay within the ``1 - dropout_rate`` share of the parameters
(the first is always kept).  SMAFD's worker falls back to it on a round
without a reserved key."""

import random

from ..message import Params
from ..utils.logging import get_logger


class RandomDropoutAlgorithm:
    def __init__(self, dropout_rate: float, seed: int | None = None) -> None:
        self.dropout_rate = dropout_rate
        self._rng = random.Random(seed)

    def drop_parameters(self, parameter_dict: Params) -> Params:
        names = list(parameter_dict)
        sizes = {k: parameter_dict[k].numel() for k in names}
        total = sum(sizes.values())
        budget = total * (1.0 - self.dropout_rate)
        self._rng.shuffle(names)
        kept: Params = {}
        used = 0
        for name in names:
            if used + sizes[name] > budget and kept:
                continue
            kept[name] = parameter_dict[name]
            used += sizes[name]
        get_logger().debug(
            "random dropout kept %d/%d tensors (%.2f%% of bytes)", len(kept), len(names), 100.0 * used / max(total, 1)
        )
        return kept
