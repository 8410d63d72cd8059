"""Layers and initialisers the port's models share.

flax's defaults, drawn on the CPU from a ``torch.Generator`` so a seed
gives the same weights on any device: lecun-normal kernels (a normal
truncated at two deviations, scaled to variance ``1 / fan_in``), zero
biases, unit norm scales, and ``nn.Embed``'s table drawn as a kernel
with fan-in ``d_model``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

# stddev of a unit normal truncated to [-2, 2] (flax's lecun_normal divisor)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    weight.copy_(w)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table is the parameter ``embedding``."""

    def __init__(self, vocab_size: int, d_model: int) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab_size, d_model))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding)


@torch.no_grad()
def init_flax_(root: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers for every Linear, Conv2d, Embed, LayerNorm and
    GroupNorm under ``root``, in module order."""
    for module in root.modules():
        if isinstance(module, nn.Linear | nn.Conv2d):
            lecun_normal_(module.weight, module.weight[0].numel(), generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, Embed):
            lecun_normal_(module.embedding, module.embedding.shape[1], generator)
        elif isinstance(module, nn.LayerNorm | nn.GroupNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()


class FlaxInit(nn.Module):
    """A model whose every parameter takes flax's default initialiser."""

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers, drawn on the CPU from ``generator``."""
        init_flax_(self, generator)
