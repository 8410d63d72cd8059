"""Text-model helpers (the port's copy of the JAX package's ``models/text.py``:
the positional table and the masked pooling; ``TransformerClassificationModel``
is not ported yet)."""

import numpy as np
import torch


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """``[max_len, d_model]`` f32 sin/cos table, the JAX package's bytes."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d_model)
    enc = np.zeros((max_len, d_model), dtype=np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)[:, : enc[:, 1::2].shape[1]]
    return enc


def masked_mean_pool(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x [B, L, D]`` over non-pad positions; a row that is all
    padding pools to 0."""
    denom = torch.clamp(pad_mask.sum(dim=1, keepdim=True), min=1)
    return (x * pad_mask[..., None]).sum(dim=1) / denom
