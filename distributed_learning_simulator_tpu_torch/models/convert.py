"""The weight bridge between the JAX package's parameters and the port's.

The JAX package keeps parameters as a flat dict of numpy arrays under
flax's ``/``-joined paths (``Block_0/FusedSelfAttention_0/qkv/kernel``);
the port's modules carry the same names, so a ``state_dict`` key is the
same path joined by ``.``.  Per leaf:

* Dense kernel ``[in, out]``  <->  Linear weight ``[out, in]``;
* DenseGeneral ``qkv`` kernel ``[D, 3, H, Dh]``  <->  packed projection
  weight ``[3, H, Dh, D]`` (its bias ``[3, H, Dh]`` unchanged);
* Conv kernel HWIO            <->  Conv2d weight OIHW;
* LayerNorm ``scale``         <->  ``weight`` (``bias`` stays ``bias``);
* anything else (``pos_embed``, ``Embed_0/embedding``) unchanged.

A 4-d kernel is a convolution unless its module is named ``qkv`` (the
long-context models' DenseGeneral): the rule is chosen by the path, not by
the number of dimensions alone.  Both directions only transpose, so
JAX -> port -> JAX is exact.
"""

from collections.abc import Mapping

import numpy as np
import torch


def from_jax(params: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX flat params (numpy) -> the port's ``state_dict`` (CPU tensors)."""
    out = {}
    for key, value in params.items():
        value = np.asarray(value)
        *path, leaf = key.split("/")
        if leaf == "kernel" and value.ndim == 2:
            leaf, value = "weight", value.T
        elif leaf == "kernel" and value.ndim == 4 and path[-1:] == ["qkv"]:
            leaf, value = "weight", value.transpose(1, 2, 3, 0)
        elif leaf == "kernel" and value.ndim == 4:
            leaf, value = "weight", value.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            raise ValueError(f"no port layout for a {value.ndim}-d kernel {key!r}")
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([*path, leaf])] = torch.from_numpy(np.array(value, copy=True))
    return out


def to_jax(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's ``state_dict`` -> JAX flat params (numpy)."""
    out = {}
    for key, tensor in state.items():
        value = tensor.detach().cpu().numpy()
        *path, leaf = key.split(".")
        if leaf == "weight" and value.ndim == 2:
            leaf, value = "kernel", value.T
        elif leaf == "weight" and value.ndim == 4 and path[-1:] == ["qkv"]:
            leaf, value = "kernel", value.transpose(3, 0, 1, 2)
        elif leaf == "weight" and value.ndim == 4:
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and value.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            raise ValueError(f"no JAX layout for a {value.ndim}-d weight {key!r}")
        out["/".join([*path, leaf])] = np.ascontiguousarray(value)
    return out
