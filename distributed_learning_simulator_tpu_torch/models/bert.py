"""BERT-class text encoders (the port's ``models/bert.py``).

``BertClassifier``: learned token and position embeddings with a
LayerNorm, a post-LN encoder stack in the BERT placement (the port's
``text.EncoderLayer`` with gelu, dropout on the attention output and
after the second FFN dense), a masked mean pool (the synthetic tokenizer
emits no [CLS]), a tanh pooler and a class head.  There are no pretrained
weights: the model trains from its init at the published shapes
(``bert_base``: 12 layers, d_model 768, 12 heads, MLP 3072).

Submodules carry the flax names (``token_embed``, ``embed_norm``,
``Layer_i``, ``pooler``, ``classifier``; the root parameter
``pos_embed`` ``[1, max_len, d_model]``), so the weight bridge
(``models/convert.py``) maps them with its existing rules.  flax's
initialisers (``models/layers.py``), then ``pos_embed ~ N(0, 0.02)``.
Dropout draws from the generator passed to ``forward``
(``models/dropout.py``).
"""

import torch
from torch import nn

from .dropout import Dropout
from .layers import Embed, init_flax_
from .registry import ModelContext, example_batch, register_model
from .text import _LN_EPS, EncoderLayer, masked_mean_pool


class BertClassifier(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        num_classes: int,
        d_model: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        max_len: int = 512,
        pad_id: int = 0,
        dropout_rate: float = 0.1,
    ) -> None:
        super().__init__()
        self.pad_id = pad_id
        self.num_layers = num_layers
        self.token_embed = Embed(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, d_model))
        self.embed_norm = nn.LayerNorm(d_model, eps=_LN_EPS)
        for i in range(num_layers):
            self.add_module(
                f"Layer_{i}",
                EncoderLayer(
                    d_model,
                    num_heads,
                    mlp_dim,
                    dropout_rate,
                    activation="gelu",
                    attn_out_dropout=True,
                    ffn_dropout_on_output=True,
                ),
            )
        self.pooler = nn.Linear(d_model, d_model)
        self.classifier = nn.Linear(d_model, num_classes)
        self.dropout = Dropout(dropout_rate)
        #: the regions remat checkpoints one by one (``engine/engine.py``)
        self.remat_blocks = tuple(f"Layer_{i}" for i in range(num_layers))

    def forward(self, tokens: torch.Tensor, generator=None) -> torch.Tensor:
        pad_mask = tokens != self.pad_id
        x = self.token_embed(tokens) + self.pos_embed[:, : tokens.shape[1]]
        x = self.dropout(self.embed_norm(x), generator)
        for i in range(self.num_layers):
            x = getattr(self, f"Layer_{i}")(x, pad_mask, generator)
        pooled = torch.tanh(self.pooler(masked_mean_pool(x, pad_mask)))
        return self.classifier(self.dropout(pooled, generator))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers (``models/layers.py``), then
        ``pos_embed ~ N(0, 0.02)``."""
        init_flax_(self, generator)
        pos = torch.empty(self.pos_embed.shape).normal_(0.0, 0.02, generator=generator)
        self.pos_embed.copy_(pos)


def _make_bert(
    dataset_collection,
    device,
    *,
    d_model,
    num_layers,
    num_heads,
    mlp_dim,
    name,
    max_len=0,
    dropout_rate=0.1,
) -> ModelContext:
    meta = dataset_collection.metadata
    module = BertClassifier(
        vocab_size=meta.get("vocab_size", 30522),
        num_classes=dataset_collection.num_classes,
        d_model=d_model,
        num_layers=num_layers,
        num_heads=num_heads,
        mlp_dim=mlp_dim,
        max_len=max_len or meta.get("max_len", example_batch(dataset_collection).shape[1]),
        pad_id=meta.get("pad_id", 0),
        dropout_rate=dropout_rate,
    ).to(device)
    return ModelContext(
        name=name,
        module=module,
        num_classes=dataset_collection.num_classes,
        device=device,
        dataset_type="text",
        pad_id=meta.get("pad_id", 0),
    )


@register_model("bert_base", "bert-base", "BertForSequenceClassification")
def _bert_base(dataset_collection, device, max_len: int = 0, dropout_rate: float = 0.1,
               **kwargs) -> ModelContext:
    return _make_bert(
        dataset_collection, device,
        d_model=768, num_layers=12, num_heads=12, mlp_dim=3072,
        name="bert_base", max_len=max_len, dropout_rate=dropout_rate,
    )


@register_model("bert_small", "bert-small")
def _bert_small(dataset_collection, device, max_len: int = 0, dropout_rate: float = 0.1,
                **kwargs) -> ModelContext:
    return _make_bert(
        dataset_collection, device,
        d_model=256, num_layers=4, num_heads=4, mlp_dim=1024,
        name="bert_small", max_len=max_len, dropout_rate=dropout_rate,
    )


@register_model("bert_tiny", "bert-tiny")
def _bert_tiny(dataset_collection, device, max_len: int = 0, dropout_rate: float = 0.1,
               **kwargs) -> ModelContext:
    # test-scale variant
    return _make_bert(
        dataset_collection, device,
        d_model=32, num_layers=2, num_heads=2, mlp_dim=64,
        name="bert_tiny", max_len=max_len, dropout_rate=dropout_rate,
    )
