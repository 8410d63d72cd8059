"""Vision Transformer family (the port's ``models/vit.py``).

Pre-LN encoder blocks, a strided-convolution patch embedding, a learned
position embedding and mean pooling over patches (no CLS token).  The
input is NHWC, as the datasets store it; the patch embedding permutes to
NCHW internally and flattens patches row-major, as the JAX reshape
``[B, H', W', D] -> [B, H'W', D]`` does.

Submodules carry the flax names (``Block_0``, ``LayerNorm_0``,
``FusedSelfAttention_0``, ``MlpBlock_0``, ``Dense_0`` ...), so a
``state_dict`` key reads like the JAX parameter path it mirrors
(``models/convert.py``).  flax defaults kept: LayerNorm eps 1e-6, tanh
GELU, lecun-normal kernels and zero biases, ``pos_embed ~ N(0, 0.02)``.
Dropout draws from the generator passed to ``forward``
(``models/dropout.py``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .attention import FusedSelfAttention
from .dropout import Dropout
from .layers import init_flax_
from .registry import ModelContext, example_batch, register_model

_LN_EPS = 1e-6


class MlpBlock(nn.Module):
    def __init__(self, d_model: int, mlp_dim: int, dropout_rate: float = 0.0) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(d_model, mlp_dim)
        self.Dense_1 = nn.Linear(mlp_dim, d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = self.dropout(F.gelu(self.Dense_0(x), approximate="tanh"), generator)
        return self.dropout(self.Dense_1(y), generator)


class ViTBlock(nn.Module):
    """Pre-LN transformer encoder block."""

    def __init__(
        self, d_model: int, num_heads: int, mlp_dim: int, dropout_rate: float = 0.0
    ) -> None:
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.FusedSelfAttention_0 = FusedSelfAttention(d_model, num_heads, dropout_rate)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.MlpBlock_0 = MlpBlock(d_model, mlp_dim, dropout_rate)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = self.FusedSelfAttention_0(self.LayerNorm_0(x), generator=generator)
        x = x + self.dropout(y, generator)
        return x + self.MlpBlock_0(self.LayerNorm_1(x), generator)


class VisionTransformer(nn.Module):
    def __init__(
        self,
        num_classes: int,
        image_size: int,
        channels: int,
        patch_size: int = 4,
        d_model: int = 768,
        num_layers: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        dropout_rate: float = 0.0,
    ) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.patch_embed = nn.Conv2d(channels, d_model, patch_size, stride=patch_size)
        n_patches = (image_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches, d_model))
        self.dropout = Dropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(
                f"Block_{i}", ViTBlock(d_model, num_heads, mlp_dim, dropout_rate)
            )
        self.encoder_norm = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.head = nn.Linear(d_model, num_classes)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        x = x.flatten(2).transpose(1, 2)  # [B, N_patches, D], row-major patches
        x = self.dropout(x + self.pos_embed, generator)
        for i in range(self.num_layers):
            x = getattr(self, f"Block_{i}")(x, generator)
        x = self.encoder_norm(x).mean(dim=1)  # global average pool over patches
        return self.head(x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers (``models/layers.py``), then
        ``pos_embed ~ N(0, 0.02)``."""
        init_flax_(self, generator)
        pos = torch.empty(self.pos_embed.shape).normal_(0.0, 0.02, generator=generator)
        self.pos_embed.copy_(pos)


def _auto_patch(image_size: int) -> int:
    """16px patches at 224-scale inputs; small inputs (CIFAR) use 4."""
    return 16 if image_size >= 128 else 4


def _make_vit(
    dataset_collection,
    device,
    *,
    d_model,
    num_layers,
    num_heads,
    mlp_dim,
    name,
    patch_size=0,
    dropout_rate=0.0,
) -> ModelContext:
    example = example_batch(dataset_collection)
    image_size, channels = example.shape[1], example.shape[3]
    module = VisionTransformer(
        num_classes=dataset_collection.num_classes,
        image_size=image_size,
        channels=channels,
        patch_size=patch_size or _auto_patch(image_size),
        d_model=d_model,
        num_layers=num_layers,
        num_heads=num_heads,
        mlp_dim=mlp_dim,
        dropout_rate=dropout_rate,
    ).to(device)
    return ModelContext(
        name=name, module=module, num_classes=dataset_collection.num_classes, device=device
    )


@register_model("vit_base", "ViT-Base", "vit-b")
def _vit_base(dataset_collection, device, patch_size: int = 0, dropout_rate: float = 0.0,
              **kwargs) -> ModelContext:
    return _make_vit(
        dataset_collection, device,
        d_model=768, num_layers=12, num_heads=12, mlp_dim=3072,
        name="vit_base", patch_size=patch_size, dropout_rate=dropout_rate,
    )


@register_model("vit_small", "ViT-Small")
def _vit_small(dataset_collection, device, patch_size: int = 0, dropout_rate: float = 0.0,
               **kwargs) -> ModelContext:
    return _make_vit(
        dataset_collection, device,
        d_model=384, num_layers=12, num_heads=6, mlp_dim=1536,
        name="vit_small", patch_size=patch_size, dropout_rate=dropout_rate,
    )


@register_model("vit_tiny", "ViT-Tiny")
def _vit_tiny(dataset_collection, device, patch_size: int = 0, dropout_rate: float = 0.0,
              **kwargs) -> ModelContext:
    # test-scale variant: same topology, toy widths
    return _make_vit(
        dataset_collection, device,
        d_model=32, num_layers=2, num_heads=2, mlp_dim=64,
        name="vit_tiny", patch_size=patch_size or 8, dropout_rate=dropout_rate,
    )
