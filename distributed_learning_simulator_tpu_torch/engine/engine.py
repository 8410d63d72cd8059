"""The compute engine (the port's ``engine/engine.py``).

The JAX engine compiles an epoch into one ``lax.scan``; here an epoch is a
Python loop over batches that stay on the device.  A client's parameters
are ONE flat vector (``ops/pytree.py``): every step splits it into views,
runs the model on them through ``functional_call``, and gets one flat
gradient back, which the hand-written SGD (``hyper_parameter.py``) applies
in place.  Dropout draws from the ``torch.Generator`` the caller passes
(one per client and round).  The metrics stay on the device until the
caller reads them.
"""

from collections.abc import Sequence

import numpy as np
import torch

from ..models.registry import ModelContext
from ..ops.pytree import ParamVecLayout
from .hyper_parameter import HyperParameter, SGDState


class ComputeEngine:
    def __init__(
        self, model_ctx: ModelContext, hyper_parameter: HyperParameter, total_steps: int
    ) -> None:
        self.model_ctx = model_ctx
        self.hyper_parameter = hyper_parameter
        self.total_steps = max(1, total_steps)
        self.optimizer = hyper_parameter.make_optimizer(self.total_steps)
        if hyper_parameter.extra:
            raise NotImplementedError(
                f"extra_hyper_parameters {sorted(hyper_parameter.extra)} are not ported yet"
            )
        self.layout = ParamVecLayout.of(model_ctx.module.state_dict())

    def init_params(self, seed: int) -> dict[str, torch.Tensor]:
        return self.model_ctx.init(seed)

    def init_opt_state(self, flat_params: torch.Tensor) -> SGDState:
        return self.optimizer.init(flat_params)

    def train_step(
        self,
        flat_params: torch.Tensor,
        opt_state: SGDState,
        batch: dict,
        count: float,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor] | None:
        """One SGD step on ``flat_params`` in place.  ``count`` is the
        batch's loss count (samples; tokens under ``causal_lm``), known on
        the host: a batch that counts 0 is a true no-op, as in the JAX
        engine: it neither decays the momentum trace nor advances the
        schedule, and draws no dropout bits."""
        if count <= 0:
            return None
        leaf = flat_params.detach().requires_grad_(True)
        loss, aux = self.model_ctx.loss(
            self.layout.split(leaf), batch, train=True, generator=generator
        )
        loss.backward()
        self.optimizer.step(flat_params, leaf.grad, opt_state)
        return {"loss": loss.detach(), "correct": aux["correct"], "count": aux["count"]}

    def train_epoch(
        self,
        flat_params: torch.Tensor,
        opt_state: SGDState,
        batches: dict,
        counts: Sequence[float],
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """One epoch over ``batches`` (``[n_batches, B, ...]`` tensors);
        returns the summed metrics."""
        device = flat_params.device
        summed = {k: torch.zeros((), device=device) for k in ("loss_sum", "correct", "count")}
        for i, count in enumerate(counts):
            metrics = self.train_step(
                flat_params, opt_state, {k: v[i] for k, v in batches.items()}, count, generator
            )
            if metrics is not None:
                summed["loss_sum"] += metrics["loss"] * metrics["count"]
                summed["correct"] += metrics["correct"]
                summed["count"] += metrics["count"]
        return summed

    @torch.no_grad()
    def evaluate(self, params, batches: dict) -> dict[str, torch.Tensor]:
        """Summed eval metrics over ``batches``."""
        device = batches["mask"].device
        summed = {k: torch.zeros((), device=device) for k in ("loss_sum", "correct", "count")}
        for i in range(batches["mask"].shape[0]):
            _, aux = self.model_ctx.loss(params, {k: v[i] for k, v in batches.items()})
            summed["loss_sum"] += aux["loss_sum"].sum()
            summed["correct"] += aux["correct"]
            summed["count"] += aux["count"]
        return summed

    @torch.no_grad()
    def confusion(self, params, batches: dict) -> torch.Tensor:
        """Confusion matrix ``[num_classes, num_classes]`` (rows = true,
        cols = predicted) over ``batches``."""
        n = self.model_ctx.num_classes
        cast = self.model_ctx._cast_for_compute
        acc = torch.zeros(n, n, device=batches["mask"].device)
        for i in range(batches["mask"].shape[0]):
            logits = self.model_ctx.apply(cast(params), cast(batches["input"][i]))
            pred = logits.argmax(dim=-1)
            true = batches["target"][i].long()
            acc.index_put_(
                (true, pred), batches["mask"][i].to(torch.float32), accumulate=True
            )
        return acc


def slow_metrics_from_confusion(confusion) -> dict:
    """Per-class accuracy (recall) and macro F1 from a confusion matrix."""
    cm = np.asarray(confusion, np.float64)
    true_pos = np.diag(cm)
    per_class_total = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    per_class_acc = true_pos / np.maximum(per_class_total, 1.0)
    f1 = 2 * true_pos / np.maximum(per_class_total + predicted, 1.0)
    return {
        "per_class_accuracy": [round(float(a), 6) for a in per_class_acc],
        "macro_f1": float(f1.mean()),
    }


def maybe_slow_metrics(config, engine: ComputeEngine, params, batches) -> dict:
    """The ``use_slow_performance_metrics`` extras, or ``{}``.  A causal
    LM has no per-class metrics: its classes are the vocab, whose
    confusion matrix is ``[V, V]``."""
    if not config.use_slow_performance_metrics or engine.model_ctx.loss_type == "causal_lm":
        return {}
    return slow_metrics_from_confusion(engine.confusion(params, batches).cpu().numpy())


def summarize_metrics(summed: dict) -> dict[str, float]:
    count = max(float(summed["count"]), 1.0)
    return {
        "loss": float(summed["loss_sum"]) / count,
        "accuracy": float(summed["correct"]) / count,
        "count": count,
    }
