"""Single-device dense attention (the port's part of the JAX package's
``parallel/ring_attention.py``: ``dense_attention`` and ``_combined_mask``).

This is the route below the kernels' window (``ops/fused_attention.py::
kernel_tier`` returns None), which the JAX package also leaves to its
compiler.  Ring and Ulysses attention and ``sharded_attention`` belong to
the multi-GPU slice of the port and are not here yet.
"""

import torch

_NEG_INF = -1e30


def _combined_mask(q_pos, k_pos, kv_mask, causal: bool, batch: int):
    """``[B, Tq, Tk]`` boolean mask (True = may attend), or None."""
    mask = None
    if causal:
        mask = (q_pos[:, None] >= k_pos[None, :])[None].expand(batch, -1, -1)
    if kv_mask is not None:
        pad = kv_mask[:, None, :].to(torch.bool).expand(batch, q_pos.shape[0], k_pos.shape[0])
        mask = pad if mask is None else (mask & pad)
    return mask


def dense_attention(q, k, v, causal: bool = False, kv_mask=None):
    """Softmax attention over ``[B, T, H, Dh]`` with the ``[B, H, T, T]``
    scores in memory: scores in the input dtype, scaled and softmaxed in
    f32, ``P·V`` in f32, the result in the input dtype (the JAX function's
    dtypes)."""
    batch, dim = q.shape[0], q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(dim, dtype=torch.float32))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale.to(q.device)
    device = q.device
    mask = _combined_mask(
        torch.arange(q.shape[1], device=device),
        torch.arange(k.shape[1], device=device),
        kv_mask,
        causal,
        batch,
    )
    if mask is not None:
        s = torch.where(mask[:, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = p * mask[:, None]
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
