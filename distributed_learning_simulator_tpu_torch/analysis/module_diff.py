"""Per-submodule parameter-drift logging (the port's copy of the JAX
package's ``analysis/module_diff.py``; reference:
``simulation_lib/analysis/module_diff.py:8-44``, the ``ModuleDiff`` hook):
after each parameter load, log the L2 drift of every top-level module
block, a debugging aid for aggregation regressions.  It takes the port's
parameter dicts (``state_dict`` keys, ``.``-joined); a block is the key's
first component, the same block the JAX package's ``/``-joined key names.
"""

import torch

from ..utils.logging import get_logger


class ModuleDiff:
    def __init__(self) -> None:
        self._last: dict[str, torch.Tensor] | None = None

    def observe(self, params: dict[str, torch.Tensor]) -> dict[str, float]:
        drifts: dict[str, float] = {}
        if self._last is not None:
            blocks: dict[str, float] = {}
            for name in params:
                block = name.split(".")[0]
                delta = torch.sum(torch.square(params[name].float() - self._last[name].float()))
                blocks[block] = blocks.get(block, 0.0) + float(delta)
            drifts = {block: value**0.5 for block, value in blocks.items()}
            for block, value in sorted(drifts.items()):
                get_logger().debug("module %s drift %.6f", block, value)
        self._last = dict(params)
        return drifts
