"""Dropout that draws from an explicit generator.

Every dropout site of the port's models takes its random bits from the
``torch.Generator`` handed to the model's ``forward`` (the session makes
one per client and round, seeded from ``(seed, round, worker)``:
:func:`dropout_generator`), so nothing draws from torch's global RNG and
a seed gives the same run.  The bits are not the JAX package's: flax
draws its mask from a threefry key, which PyTorch cannot reproduce; the
rule is the same (keep with probability ``1 - rate``, scale kept values
by ``1 / (1 - rate)``, select, as flax's ``Dropout`` does).
"""

import numpy as np
import torch
from torch import nn


def dropout_generator(seed: int, round_number: int, worker: int, device) -> torch.Generator:
    """The generator of one client's training in one round."""
    state = np.random.SeedSequence([seed, round_number, worker]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) & (2**63 - 1))


class Dropout(nn.Module):
    """Inverted dropout; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("dropout in training needs a torch.Generator")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
