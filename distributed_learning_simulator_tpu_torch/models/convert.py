"""The weight bridge between the JAX package's parameters and the port's.

The JAX package keeps parameters as a flat dict of numpy arrays under
flax's ``/``-joined paths (``Block_0/FusedSelfAttention_0/qkv/kernel``);
the port's modules carry the same names, so a ``state_dict`` key is the
same path joined by ``.``.  Per leaf:

* Dense kernel ``[in, out]``  <->  Linear weight ``[out, in]``;
* DenseGeneral ``qkv`` kernel ``[D, 3, H, Dh]``  <->  packed projection
  weight ``[3, H, Dh, D]`` (its bias ``[3, H, Dh]`` unchanged);
* Conv kernel HWIO            <->  Conv2d weight OIHW (a bias, where the
  convolution has one, unchanged);
* LayerNorm and GroupNorm ``scale``  <->  ``weight`` (``bias`` stays ``bias``);
* anything else (``pos_embed``, ``Embed_0/embedding``) unchanged.

A 4-d kernel is a convolution unless its module is named ``qkv`` (the
long-context models' DenseGeneral): the rule is chosen by the path, not by
the number of dimensions alone.  Both directions only transpose, so
JAX -> port -> JAX is exact.
"""

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch


def _port_key(key: str, ndim: int) -> tuple[str, tuple[int, ...] | None]:
    """A JAX path and the permutation that takes its array to the port's
    layout (None: unchanged)."""
    *path, leaf = key.split("/")
    perm = None
    if leaf == "kernel" and ndim == 2:
        leaf, perm = "weight", (1, 0)
    elif leaf == "kernel" and ndim == 4 and path[-1:] == ["qkv"]:
        leaf, perm = "weight", (1, 2, 3, 0)
    elif leaf == "kernel" and ndim == 4:
        leaf, perm = "weight", (3, 2, 0, 1)
    elif leaf == "kernel":
        raise ValueError(f"no port layout for a {ndim}-d kernel {key!r}")
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*path, leaf]), perm


def _jax_key(key: str, ndim: int) -> tuple[str, tuple[int, ...] | None]:
    """A port key and the permutation that takes its tensor to the JAX
    package's layout (None: unchanged)."""
    *path, leaf = key.split(".")
    perm = None
    if leaf == "weight" and ndim == 2:
        leaf, perm = "kernel", (1, 0)
    elif leaf == "weight" and ndim == 4 and path[-1:] == ["qkv"]:
        leaf, perm = "kernel", (3, 0, 1, 2)
    elif leaf == "weight" and ndim == 4:
        leaf, perm = "kernel", (2, 3, 1, 0)
    elif leaf == "weight" and ndim == 1:
        leaf = "scale"
    elif leaf == "weight":
        raise ValueError(f"no JAX layout for a {ndim}-d weight {key!r}")
    return "/".join([*path, leaf]), perm


def from_jax(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX flat params (numpy) -> the port's ``state_dict`` (CPU tensors)."""
    out = {}
    for key, value in params.items():
        value = np.asarray(value)
        name, perm = _port_key(key, value.ndim)
        if perm is not None:
            value = value.transpose(perm)
        out[name] = torch.from_numpy(np.array(value, copy=True))
    return out


def to_jax(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's ``state_dict`` -> JAX flat params (numpy)."""
    return {
        key: np.ascontiguousarray(t.detach().cpu().numpy())
        for key, t in to_jax_tensors(state).items()
    }


def to_jax_tensors(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's parameters in the JAX package's keys and layouts, as
    tensors on their own device (permuted views, no copy): the wire
    layout of the transport codec, so a leaf's values meet the same
    random draws in the same order as in the JAX package."""
    out = {}
    for key, tensor in state.items():
        name, perm = _jax_key(key, tensor.dim())
        out[name] = tensor if perm is None else tensor.permute(perm)
    return out


def from_jax_tensors(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse of :func:`to_jax_tensors` (contiguous tensors)."""
    out = {}
    for key, tensor in params.items():
        name, perm = _port_key(key, tensor.dim())
        out[name] = (tensor if perm is None else tensor.permute(perm)).contiguous()
    return out


@dataclasses.dataclass(frozen=True)
class JaxLeaf:
    """One leaf of a flat parameter vector as the JAX package holds it:
    its port key, JAX key and slice of the vector, and the permutation
    that takes the port's layout to the JAX one (None: the same)."""

    key: str
    jax_key: str
    start: int
    size: int
    shape: tuple[int, ...]
    perm: tuple[int, ...] | None

    @property
    def stop(self) -> int:
        return self.start + self.size

    @property
    def jax_shape(self) -> tuple[int, ...]:
        return self.shape if self.perm is None else tuple(self.shape[p] for p in self.perm)

    def to_jax(self, flat: torch.Tensor) -> torch.Tensor:
        """The leaf's values (a flat slice in the port's layout) in the JAX
        layout's flat order: the order its codec draws meet them."""
        if self.perm is None:
            return flat
        return flat.reshape(self.shape).permute(self.perm).reshape(-1)

    def from_jax(self, flat: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`to_jax`."""
        if self.perm is None:
            return flat
        return flat.reshape(self.jax_shape).permute(tuple(np.argsort(self.perm))).reshape(-1)


def jax_leaves(keys, shapes) -> list[JaxLeaf]:
    """The leaves of a flat vector laid out as ``keys``/``shapes`` (a
    ``ParamVecLayout``'s), in the JAX package's order of its parameter
    dict: sorted JAX keys."""
    leaves, start = [], 0
    for key, shape in zip(keys, shapes):
        size = int(np.prod(shape)) if shape else 1
        jax_key, perm = _jax_key(key, len(shape))
        leaves.append(JaxLeaf(key, jax_key, start, size, tuple(shape), perm))
        start += size
    return sorted(leaves, key=lambda leaf: leaf.jax_key)


def jax_positions(keys, shapes) -> dict[str, int]:
    """Each JAX key of a layout's leaves -> its position in the JAX
    package's parameter dict (sorted JAX keys): the index a codec folds a
    leaf's draws by."""
    return {leaf.jax_key: i for i, leaf in enumerate(jax_leaves(keys, shapes))}
