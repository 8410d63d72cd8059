"""Flat parameter vectors (the port's ``ops/pytree.py``).

Parameters are a ``dict[str, Tensor]`` (a module's ``state_dict``).  The
aggregation and the optimizer work on ONE contiguous vector per client with
a static layout, the JAX package's ParamVec contract:

* keys sorted lexicographically;
* each tensor raveled row-major (C order), one after the other;
* ``size`` is the total length.

:meth:`ParamVecLayout.split` returns views into the vector, so a model run
through ``torch.func.functional_call`` on those views trains the vector
itself and autograd delivers one flat gradient.
"""

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .weighted_accum import weighted_accum


@dataclasses.dataclass(frozen=True)
class ParamVecLayout:
    """Static layout of a flat parameter vector."""

    keys: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    size: int

    @classmethod
    def of(cls, params: Mapping[str, torch.Tensor]) -> "ParamVecLayout":
        keys = tuple(sorted(params))
        shapes = tuple(tuple(int(s) for s in params[k].shape) for k in keys)
        return cls(keys, shapes, sum(_numel(s) for s in shapes))

    def matches(self, params: Mapping[str, torch.Tensor]) -> bool:
        """Keys AND shapes agree (a transposed kernel of the same size
        would otherwise flatten into a misaligned sum)."""
        if tuple(sorted(params)) != self.keys:
            return False
        return all(
            tuple(params[key].shape) == shape for key, shape in zip(self.keys, self.shapes)
        )

    def flatten(self, params: Mapping[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
        """One vector in ``dtype`` holding ``params`` in layout order."""
        if not self.matches(params):
            raise ValueError("params do not match the layout's keys and shapes")
        return torch.cat([params[k].reshape(-1).to(dtype) for k in self.keys])

    def split(self, vector: torch.Tensor) -> dict[str, torch.Tensor]:
        """Views of ``vector`` shaped like the layout's tensors (no copy;
        the views keep ``vector``'s dtype).  Leading dims stay: the rows
        of an ``[S, size]`` matrix (unit stride along a row) split into
        ``[S, *shape]`` views."""
        if vector.shape[-1:] != (self.size,):
            raise ValueError(f"vector of shape {tuple(vector.shape)}, layout size {self.size}")
        lead = vector.shape[:-1]
        pieces = torch.split(vector, [_numel(s) for s in self.shapes], dim=-1)
        return {k: p.view(*lead, *s) for k, p, s in zip(self.keys, pieces, self.shapes)}


def _numel(shape: tuple[int, ...]) -> int:
    return int(np.prod(shape)) if shape else 1


def k1_stack(rows: int, size: int, device) -> torch.Tensor:
    """A zeroed f32 ``[rows, size]`` stack for K1, each row starting on a
    128-byte boundary (a view into a ``[rows, size padded to 64]`` buffer)."""
    row_stride = -(-size // 64) * 64
    return torch.zeros(rows, row_stride, dtype=torch.float32, device=device)[:, :size]


def flat_stack_weighted_sum(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``w @ [K, D]`` accumulated in f32 through kernel K1
    (:func:`~.weighted_accum.weighted_accum`).

    The JAX function takes a leading-axis-stacked params tree, concatenates
    it into an f32 ``[K, D]`` matrix and contracts.  The port keeps a
    chunk's trained clients as one ``[K, D]`` matrix in the compute dtype
    from the start (rows written in layout order), so neither the concat
    nor the f32 copy exists: K1 reads the bf16 or f32 rows as they are."""
    return weighted_accum(stacked, weights.to(torch.float32).contiguous())
