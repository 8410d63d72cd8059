"""Long-context transformer (the port's ``models/long_context.py``).

A pre-LN encoder stack over token ids with sinusoidal positions, a packed
QKV projection per layer and either a masked-mean-pooled class head
(``LongContextTransformer``) or a per-token vocab head with causal
attention (``CausalLMTransformer``).  Attention takes the JAX package's
single-device route: shapes :func:`~..ops.fused_attention.kernel_eligible`
admits run the long-sequence kernels (K6-K11) on strided views of the
packed projection; the rest run :func:`~..parallel.ring_attention.
dense_attention`.  The sequence-parallel modes (``sp_mesh``, ``sp_axis``)
belong to the multi-GPU slice of the port and raise here.

Submodules carry the flax names (``Embed_0``, ``LongContextEncoderLayer_i``,
``LongContextSelfAttention_0``, ``qkv``, ``out``, ``LayerNorm_i``,
``Dense_i``), so a ``state_dict`` key reads like the JAX parameter path
(``models/convert.py``).  The ``qkv`` kernel is kept as ``[3, H, Dh, D]``
(flax's DenseGeneral ``[D, 3, H, Dh]`` with the input axis last), so the
bridge is a transpose both ways.  Dropout follows ``models/dropout.py``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_attention import fused_attention, kernel_eligible
from ..parallel.ring_attention import dense_attention
from .dropout import Dropout
from .layers import Embed, lecun_normal_
from .registry import ModelContext, register_model
from .text import masked_mean_pool, sinusoidal_positions

_LN_EPS = 1e-6  # flax LayerNorm


class PackedQKV(nn.Module):
    """flax ``DenseGeneral((3, H, Dh))``: ``[B, T, D] -> [B, T, 3, H, Dh]``."""

    def __init__(self, d_model: int, nhead: int, head_dim: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, nhead, head_dim, d_model))
        self.bias = nn.Parameter(torch.zeros(3, nhead, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(-1, self.weight.shape[-1])
        y = F.linear(x, w, self.bias.reshape(-1))
        return y.view(*x.shape[:-1], *self.bias.shape)


class LongContextSelfAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, causal: bool = False) -> None:
        super().__init__()
        self.nhead = nhead
        self.head_dim = d_model // nhead
        self.causal = causal
        self.qkv = PackedQKV(d_model, nhead, self.head_dim)
        self.out = nn.Linear(nhead * self.head_dim, d_model)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        batch, length, _ = x.shape
        q, k, v = self.qkv(x).unbind(dim=2)  # strided [B, T, H, Dh] views
        if kernel_eligible(length, self.head_dim, q.element_size()):
            out = fused_attention(q, k, v, kv_mask=pad_mask, causal=self.causal)
        else:
            out = dense_attention(q, k, v, causal=self.causal, kv_mask=pad_mask)
        return self.out(out.reshape(batch, length, self.nhead * self.head_dim))


class LongContextEncoderLayer(nn.Module):
    def __init__(
        self, d_model: int, nhead: int, dropout_rate: float = 0.1, causal: bool = False
    ) -> None:
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.LongContextSelfAttention_0 = LongContextSelfAttention(d_model, nhead, causal)
        self.Dropout_0 = Dropout(dropout_rate)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.Dense_0 = nn.Linear(d_model, 4 * d_model)
        self.Dense_1 = nn.Linear(4 * d_model, d_model)
        self.Dropout_1 = Dropout(dropout_rate)

    def forward(self, x, pad_mask, generator=None):
        y = self.LongContextSelfAttention_0(self.LayerNorm_0(x), pad_mask)
        x = x + self.Dropout_0(y, generator)
        y = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh"))
        return x + self.Dropout_1(y, generator)


class LongContextTransformer(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        num_classes: int,
        d_model: int = 256,
        nhead: int = 8,
        num_encoder_layer: int = 4,
        max_len: int = 8192,
        pad_id: int = 0,
        dropout_rate: float = 0.1,
        causal: bool = False,
        lm_head: bool = False,
    ) -> None:
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by {nhead} heads")
        self.pad_id = pad_id
        self.num_encoder_layer = num_encoder_layer
        self.lm_head = lm_head
        self.Embed_0 = Embed(vocab_size, d_model)
        self.register_buffer(
            "positions",
            torch.from_numpy(sinusoidal_positions(max_len, d_model)),
            persistent=False,
        )
        for i in range(num_encoder_layer):
            self.add_module(
                f"LongContextEncoderLayer_{i}",
                LongContextEncoderLayer(d_model, nhead, dropout_rate, causal),
            )
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.Dense_0 = nn.Linear(d_model, num_classes)

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        pad_mask = tokens != self.pad_id
        x = self.Embed_0(tokens)
        # in the compute dtype: an f32 table would promote bf16 layers to f32
        x = x + self.positions[None, : tokens.shape[1]].to(x.dtype)
        for i in range(self.num_encoder_layer):
            x = getattr(self, f"LongContextEncoderLayer_{i}")(x, pad_mask, generator)
        x = self.LayerNorm_0(x)
        if self.lm_head:
            return self.Dense_0(x)  # [B, L, V]; the loss shifts the targets
        return self.Dense_0(masked_mean_pool(x, pad_mask))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers, drawn on the CPU from ``generator``:
        lecun-normal kernels and embedding (fan-in ``d_model``), zero
        biases, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                lecun_normal_(module.weight, module.weight.shape[1], generator)
                module.bias.zero_()
            elif isinstance(module, PackedQKV):
                lecun_normal_(module.weight, module.weight.shape[-1], generator)
                module.bias.zero_()
            elif isinstance(module, Embed):
                lecun_normal_(module.embedding, module.embedding.shape[1], generator)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()


@register_model("LongContextTransformer", "longcontexttransformer")
def _long_context_transformer(
    dataset_collection,
    device,
    d_model: int = 256,
    nhead: int = 8,
    num_encoder_layer: int = 4,
    max_len: int = 0,
    sp_mesh=None,
    sp_impl: str = "ring",
    sp_axis: str = "",
    dropout_rate: float = 0.1,
    causal: bool = False,
    lm_head: bool = False,
    **kwargs,
) -> ModelContext:
    if sp_mesh is not None or sp_axis:
        raise NotImplementedError(
            "sequence-parallel LongContextTransformer (sp_mesh / sp_axis) runs ring or"
            " Ulysses attention across GPUs: the multi-GPU slice of the port"
            " (ROADMAP.md), not ported yet"
        )
    meta = dataset_collection.metadata
    vocab_size = meta.get("vocab_size", 32000)
    num_classes = vocab_size if lm_head else dataset_collection.num_classes
    module = LongContextTransformer(
        vocab_size=vocab_size,
        num_classes=num_classes,
        d_model=d_model,
        nhead=nhead,
        num_encoder_layer=num_encoder_layer,
        max_len=max_len or meta.get("max_len", 8192),
        pad_id=meta.get("pad_id", 0),
        dropout_rate=dropout_rate,
        causal=causal,
        lm_head=lm_head,
    ).to(device)
    return ModelContext(
        name="LongContextTransformer",
        module=module,
        num_classes=num_classes,
        device=device,
        dataset_type="text",
        pad_id=meta.get("pad_id", 0),
    )


@register_model("CausalLMTransformer", "causallmtransformer")
def _causal_lm_transformer(dataset_collection, device, **kwargs) -> ModelContext:
    """GPT-style next-token LM: the long-context stack with causal attention
    and a per-token vocab head; ``loss_type="causal_lm"`` takes its targets
    from the input tokens shifted left (dataset labels are ignored)."""
    kwargs.update(causal=True, lm_head=True)
    ctx = _long_context_transformer(dataset_collection, device, **kwargs)
    ctx.name = "CausalLMTransformer"
    ctx.loss_type = "causal_lm"
    return ctx
