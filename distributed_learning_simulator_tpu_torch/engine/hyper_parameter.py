"""Hyper-parameters and the hand-written SGD of the port.

The JAX package builds its optimizer as the optax chain
``add_decayed_weights(wd) -> trace(momentum, nesterov=False) ->
scale_by_learning_rate(schedule)`` and schedules the learning rate with a
PERIODIC cosine (``lr * 0.5 * (1 + cos(pi * count / total_steps))``, not
clamped past ``total_steps``).  :class:`SGD` is that chain written out as
in-place tensor updates on one flat parameter vector:

    g      <- g + wd * p                  (when wd != 0)
    trace  <- g + momentum * trace        (when momentum != 0)
    p      <- p + (-lr(count)) * trace    (-lr rounded to p's dtype)
    count  <- count + 1

The trace lives in the parameters' dtype (bf16 under ``use_amp``, as the
optax state initialised from bf16 params does).  The learning rate is
computed in float32 like the JAX schedule.
"""

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class HyperParameter:
    epoch: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    optimizer_name: str = "SGD"
    learning_rate_scheduler_name: str = "CosineAnnealingLR"
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_config(cls, config) -> "HyperParameter":
        return cls(
            epoch=config.epoch,
            batch_size=config.batch_size,
            learning_rate=config.learning_rate,
            momentum=config.momentum,
            weight_decay=config.weight_decay,
            optimizer_name=config.optimizer_name,
            learning_rate_scheduler_name=config.learning_rate_scheduler_name,
            extra=dict(config.extra_hyper_parameters),
        )

    def make_schedule(self, total_steps: int):
        """``count -> lr`` as a float32 number, the JAX schedule's value."""
        total_steps = max(1, total_steps)
        name = (self.learning_rate_scheduler_name or "").lower()
        base = self.learning_rate
        if name in ("cosineannealinglr", "cosine"):
            half_base = np.float32(base * 0.5)
            pi, total = np.float32(math.pi), np.float32(total_steps)

            def periodic_cosine(count: int) -> np.float32:
                return half_base * (np.float32(1.0) + np.cos(pi * np.float32(count) / total))

            return periodic_cosine
        raise NotImplementedError(
            f"lr scheduler {self.learning_rate_scheduler_name!r} is not ported yet"
        )

    def make_optimizer(self, total_steps: int) -> "SGD":
        if self.optimizer_name.lower() != "sgd":
            raise NotImplementedError(f"optimizer {self.optimizer_name!r} is not ported yet")
        return SGD(self.make_schedule(total_steps), self.momentum, self.weight_decay)


@dataclasses.dataclass
class SGDState:
    """The optax chain's state: the momentum trace and the schedule count."""

    trace: torch.Tensor | None
    count: int = 0


class SGD:
    """The optax SGD chain as in-place updates of a flat parameter vector."""

    def __init__(self, schedule, momentum: float, weight_decay: float) -> None:
        self.schedule = schedule
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)

    def init(self, params: torch.Tensor) -> SGDState:
        trace = torch.zeros_like(params) if self.momentum else None
        return SGDState(trace=trace, count=0)

    @torch.no_grad()
    def step(self, params: torch.Tensor, grads: torch.Tensor, state: SGDState) -> None:
        """Update ``params`` and ``state`` in place (``grads`` is consumed).
        Every scalar is first rounded to the parameters' dtype, as JAX
        rounds a weakly typed Python scalar to the array's dtype."""
        dtype = params.dtype
        if self.weight_decay:
            grads.add_(params * _rounded(self.weight_decay, dtype))
        if state.trace is not None:
            state.trace.mul_(_rounded(self.momentum, dtype)).add_(grads)
            direction = state.trace
        else:
            direction = grads
        params.add_(direction * _rounded(-float(self.schedule(state.count)), dtype))
        state.count += 1


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (host arithmetic, no device sync)."""
    return torch.tensor(value, dtype=dtype).item()
