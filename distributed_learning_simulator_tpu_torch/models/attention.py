"""Multi-head self-attention with a packed QKV projection (the port's
``models/attention.py``).

One ``[B*S, D] @ [D, 3D]`` projection (``qkv``: Q columns, then K, then V,
heads side by side), then the JAX package's routing:

* shapes :func:`~..ops.short_attention.short_eligible` admits go to the
  short-sequence kernels K4/K5, which read the packed projection in place;
* shapes the JAX package sends to its long-sequence Pallas kernels
  (``ops/fused_attention.py``, kernels K6-K11) raise
  ``NotImplementedError``: the port has those kernels
  (``ops/fused_attention.py``) but this module's route to them is not
  wired yet (``models/long_context.py`` is the model that runs them);
* everything else, and attention-probability dropout in training, takes
  the dense ``[B, H, S, S]`` path in plain PyTorch, which the JAX package
  also leaves to its compiler.
"""

import torch
from torch import nn

from ..ops.fused_attention import kernel_eligible
from ..ops.short_attention import short_attention, short_eligible
from .dropout import Dropout


class FusedSelfAttention(nn.Module):
    """``mask``, when given, is a key-padding mask broadcastable to
    ``[B, H, S_q, S_k]`` with True = attend (``[B, 1, 1, S]``)."""

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float = 0.0) -> None:
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out = nn.Linear(d_model, d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor | None = None, generator=None
    ) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = self.qkv(x)
        drop_active = self.dropout_rate > 0.0 and self.training
        if not drop_active and short_eligible(s, d, h, x.element_size()):
            kv_mask = None
            if mask is not None:
                kv_mask = torch.broadcast_to(mask, (b, 1, 1, s))[:, 0, 0, :]
            return self.out(short_attention(qkv, h, kv_mask=kv_mask))
        if not drop_active and kernel_eligible(s, dh, x.element_size()):
            raise NotImplementedError(
                f"attention at S={s}, head dim {dh} runs the long-sequence kernels"
                " (JAX ops/fused_attention.py, K6-K11); this module's route to the"
                " port's K6-K11 is not wired yet (ROADMAP.md)"
            )
        q, k, v = (t.reshape(b, s, h, dh) for t in qkv.split(d, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q * dh**-0.5, k)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits.to(torch.float32), dim=-1).to(x.dtype)
        if drop_active:
            probs = self.dropout(probs, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
        return self.out(out)
