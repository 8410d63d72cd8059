"""Text models (the port's ``models/text.py``): the positional table, the
masked pooling, the post-LN ``EncoderLayer`` and the IMDB classifier
``TransformerClassificationModel`` (``conf/fed_avg/imdb.yaml``: d_model
100, 5 heads, 2 layers, max_len 300).

Submodules carry flax's names (``Embed_0``, ``EncoderLayer_i``,
``FusedSelfAttention_0``, ``LayerNorm_i``, ``Dense_i``), so a
``state_dict`` key is the JAX parameter path joined by ``.``.  The
classifier runs the per-layer layout only: the JAX package's stacked
``trunk`` (any nonzero ``pipeline_stages``) is not ported.  Dropout
follows ``models/dropout.py``; its rate is the JAX layer's default, 0.1.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import FusedSelfAttention
from .dropout import Dropout
from .layers import Embed, FlaxInit
from .registry import ModelContext, register_model

_LN_EPS = 1e-6  # flax LayerNorm


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


class EncoderLayer(nn.Module):
    """Post-LN encoder layer.  The IMDB classifier's placement is relu with
    dropout after the FFN activation; the BERT family's is gelu with
    dropout on the attention output (``attn_out_dropout``) and after the
    second FFN dense (``ffn_dropout_on_output``).  The JAX layer's ``ffn``
    hook (the MoE family's replacement FFN) is not ported."""

    def __init__(
        self,
        d_model: int,
        nhead: int,
        dim_feedforward: int,
        dropout_rate: float = 0.1,
        activation: str = "relu",
        attn_out_dropout: bool = False,
        ffn_dropout_on_output: bool = False,
        ffn: nn.Module | None = None,
    ) -> None:
        super().__init__()
        if ffn is not None:
            raise NotImplementedError(
                "EncoderLayer's ffn hook (the MoE family) is not ported yet (ROADMAP.md, Queue 1 item 6)"
            )
        if activation not in ("relu", "gelu"):
            raise ValueError(f"activation must be relu or gelu, not {activation!r}")
        self.activation = activation
        self.attn_out_dropout = attn_out_dropout
        self.ffn_dropout_on_output = ffn_dropout_on_output
        self.FusedSelfAttention_0 = FusedSelfAttention(d_model, nhead, dropout_rate)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.Dense_0 = nn.Linear(d_model, dim_feedforward)
        self.Dense_1 = nn.Linear(dim_feedforward, d_model)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, generator=None) -> torch.Tensor:
        mask = pad_mask[:, None, None, :]  # [B, 1, 1, L], keyed on keys
        y = self.FusedSelfAttention_0(x, mask=mask, generator=generator)
        if self.attn_out_dropout:
            y = self.dropout(y, generator)
        x = self.LayerNorm_0(x + y)
        y = self.Dense_0(x)
        y = F.gelu(y, approximate="tanh") if self.activation == "gelu" else F.relu(y)
        if not self.ffn_dropout_on_output:
            y = self.dropout(y, generator)
        y = self.Dense_1(y)
        if self.ffn_dropout_on_output:
            y = self.dropout(y, generator)
        return self.LayerNorm_1(x + y)


class TransformerClassifier(FlaxInit):
    """Token embedding plus sinusoidal positions, ``num_encoder_layer``
    post-LN layers (FFN width ``4 * d_model``), a masked mean pool and a
    class head."""

    def __init__(
        self,
        vocab_size: int,
        num_classes: int,
        d_model: int = 100,
        nhead: int = 5,
        num_encoder_layer: int = 2,
        max_len: int = 300,
        pad_id: int = 0,
    ) -> None:
        super().__init__()
        self.pad_id = pad_id
        self.num_encoder_layer = num_encoder_layer
        self.Embed_0 = Embed(vocab_size, d_model)
        self.register_buffer(
            "positions", torch.from_numpy(sinusoidal_positions(max_len, d_model)), persistent=False
        )
        for i in range(num_encoder_layer):
            self.add_module(f"EncoderLayer_{i}", EncoderLayer(d_model, nhead, 4 * d_model))
        self.Dense_0 = nn.Linear(d_model, num_classes)
        #: the regions remat checkpoints one by one (``engine/engine.py``)
        self.remat_blocks = tuple(f"EncoderLayer_{i}" for i in range(num_encoder_layer))

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        pad_mask = tokens != self.pad_id
        x = self.Embed_0(tokens)
        # in the compute dtype: an f32 table would promote bf16 layers to f32
        x = x + self.positions[None, : tokens.shape[1]].to(x.dtype)
        for i in range(self.num_encoder_layer):
            x = getattr(self, f"EncoderLayer_{i}")(x, pad_mask, generator)
        return self.Dense_0(masked_mean_pool(x, pad_mask))


@register_model("TransformerClassificationModel", "transformerclassificationmodel")
def _transformer(
    dataset_collection,
    device,
    d_model: int = 100,
    nhead: int = 5,
    num_encoder_layer: int = 2,
    max_len: int = 0,
    word_vector_name: str = "",
    pipeline_stages: int = 0,
    pp_mesh=None,
    pp_axis: str = "",
    **kwargs,
) -> ModelContext:
    if int(pipeline_stages or 0) or pp_mesh is not None or pp_axis:
        raise NotImplementedError(
            "TransformerClassificationModel with pipeline_stages / pp_mesh / pp_axis (the JAX"
            " package's stacked trunk and GPipe schedule) is not ported yet (ROADMAP.md,"
            " Queue 1 item 8: spmd_pp.py)"
        )
    meta = dataset_collection.metadata
    # the JAX factory loads GloVe vectors only where the dataset carries a
    # vocab; every synthetic dataset has none, and trains its embedding
    if word_vector_name and meta.get("vocab"):
        raise NotImplementedError(
            f"word_vector_name {word_vector_name!r} over a dataset vocab reads the real-data"
            " loader (data/real.py), which is not ported yet (ROADMAP.md,"
            " Queue 1 item 7)"
        )
    module = TransformerClassifier(
        vocab_size=meta.get("vocab_size", 20000),
        num_classes=dataset_collection.num_classes,
        d_model=d_model,
        nhead=nhead,
        num_encoder_layer=num_encoder_layer,
        max_len=max_len or meta.get("max_len", 300),
        pad_id=meta.get("pad_id", 0),
    ).to(device)
    return ModelContext(
        name="TransformerClassificationModel",
        module=module,
        num_classes=dataset_collection.num_classes,
        device=device,
        dataset_type="text",
        pad_id=meta.get("pad_id", 0),
    )
