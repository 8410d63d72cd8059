"""The compute engine (the port's ``engine/engine.py``).

The JAX engine compiles an epoch into one ``lax.scan``; here an epoch is a
Python loop over batches that stay on the device.  A client's parameters
are ONE flat vector (``ops/pytree.py``): every step splits it into views,
runs the model on them through ``functional_call``, and gets one flat
gradient back, which the hand-written SGD (``hyper_parameter.py``) applies
in place.  Dropout draws from the ``torch.Generator`` the caller passes
(one per client and round).  The metrics stay on the device until the
caller reads them.

``extra_hyper_parameters`` ``remat`` / ``remat_policy`` (the JAX engine's
``jax.checkpoint`` around the loss) become activation checkpointing
(``torch.utils.checkpoint``, non-reentrant; :func:`resolve_remat`).  XLA
recomputes a checkpointed loss op by op as the backward reaches it; eager
PyTorch recomputes a checkpointed region whole at the first tensor its
backward needs and holds all of it, so one region around the loss saves
no memory.  The regions are therefore the model's ``remat_blocks`` (its
repeated layers, each checkpointed on its own, so the backward holds one
block's recompute at a time), or the whole loss call for a model that
names none.  A block's recompute runs after ``functional_call`` has put
the module's own parameters back, so each region binds the tensors its
block had in the forward.  The recompute draws the forward's dropout
masks again: checkpointing restores only torch's global RNG states, so
each region restores the explicit generator's state before each pass and
the engine leaves it where the forward left it.  A kernel's
``autograd.Function`` inside a region runs its forward twice (once more
in the recompute), so its launch counter counts twice a step.
"""

import contextlib
import functools
from collections.abc import Sequence

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..models.registry import ModelContext
from ..ops.pytree import ParamVecLayout
from .batching import select_batch
from .hyper_parameter import HyperParameter, SGDState

#: ``jax.checkpoint_policies``' names: the vocabulary of ``remat_policy``
#: (the JAX package's; a copy, since the port imports no JAX)
JAX_CHECKPOINT_POLICIES = (
    "checkpoint_dots",
    "checkpoint_dots_with_no_batch_dims",
    "dots_saveable",
    "dots_with_no_batch_dims_saveable",
    "everything_saveable",
    "nothing_saveable",
    "offload_dot_with_no_batch_dims",
    "save_and_offload_only_these_names",
    "save_any_names_but_these",
    "save_anything_except_these_names",
    "save_from_both_policies",
    "save_only_these_names",
)
#: the policies the port implements: what each keeps from the forward
#: (``checkpoint_dots`` is JAX's alias of ``dots_saveable``)
PORTED_POLICIES = {
    "nothing_saveable": "nothing",
    "dots_saveable": "dots",
    "checkpoint_dots": "dots",
    "everything_saveable": "everything",
}
#: extra_hyper_parameters the port reads (the engine remat and
#: remat_policy, fed_aas num_neighbor); any other raises
SUPPORTED_EXTRA = frozenset({"remat", "remat_policy", "num_neighbor"})
#: what ``dots_saveable`` keeps: the outputs of JAX's ``dot_general`` and
#: ``conv_general_dilated``, here the aten ops the port's Linear, attention
#: and convolution layers lower to
_DOT_OPS = frozenset(
    {
        torch.ops.aten.mm.default,
        torch.ops.aten.addmm.default,
        torch.ops.aten.bmm.default,
        torch.ops.aten.convolution.default,
    }
)


def resolve_remat(extra) -> str | None:
    """What ``extra_hyper_parameters`` ask of the loss call, as the JAX
    engine reads them: ``"nothing"`` (recompute every activation: bare
    ``remat: true`` or ``nothing_saveable``), ``"dots"`` (keep the matrix
    products' and convolutions' outputs: ``dots_saveable``), or None (the
    plain step: no remat, or ``everything_saveable``).  A named policy
    implies remat.  An unknown name raises ``ValueError`` listing JAX's;
    a JAX policy the port does not implement raises
    ``NotImplementedError``."""
    name = extra.get("remat_policy", "") or ""
    if not name:
        return "nothing" if extra.get("remat", False) else None
    name = str(name)
    if name not in JAX_CHECKPOINT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}; valid jax.checkpoint_policies names:"
            f" {list(JAX_CHECKPOINT_POLICIES)}"
        )
    if name not in PORTED_POLICIES:
        raise NotImplementedError(
            f"remat_policy {name!r} is not ported yet; the port implements {sorted(PORTED_POLICIES)}"
        )
    kept = PORTED_POLICIES[name]
    return None if kept == "everything" else kept


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


class ComputeEngine:
    def __init__(
        self, model_ctx: ModelContext, hyper_parameter: HyperParameter, total_steps: int
    ) -> None:
        self.model_ctx = model_ctx
        self.hyper_parameter = hyper_parameter
        self.total_steps = max(1, total_steps)
        self.optimizer = hyper_parameter.make_optimizer(self.total_steps)
        unsupported = sorted(set(hyper_parameter.extra) - SUPPORTED_EXTRA)
        if unsupported:
            raise NotImplementedError(f"extra_hyper_parameters {unsupported} are not ported yet")
        #: None (the plain step), "nothing" or "dots": :func:`resolve_remat`
        self.remat = resolve_remat(hyper_parameter.extra)
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
        metrics, grad = self.loss_and_grad(flat_params, batch, generator)
        self.optimizer.step(flat_params, grad, opt_state)
        return metrics

    def loss_and_grad(
        self, flat_params: torch.Tensor, batch: dict, generator: torch.Generator | None = None
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """The training loss at ``flat_params`` (``{"loss", "correct",
        "count"}``, on the device) and its flat gradient, a new tensor in
        the parameters' dtype; the parameters are not touched."""
        leaf = flat_params.detach().requires_grad_(True)
        if self.remat is None:
            loss, aux = self.model_ctx.loss(
                self.layout.split(leaf), batch, train=True, generator=generator
            )
            loss.backward()
        else:
            loss, aux = self._remat_loss_backward(leaf, batch, generator)
        return {"loss": loss.detach(), "correct": aux["correct"], "count": aux["count"]}, leaf.grad

    def _remat_loss_backward(self, leaf: torch.Tensor, batch: dict, generator):
        """The loss call with its regions checkpointed (the module's
        ``remat_blocks``, else the whole call), and its backward into
        ``leaf.grad``, holding the module against other threads (the
        threaded executor's workers share it); the generator is left where
        the forward left it."""
        module = self.model_ctx.module
        names = getattr(module, "remat_blocks", ())

        def loss_call(flat, generator):
            return self.model_ctx.loss(self.layout.split(flat), batch, train=True, generator=generator)

        # the module to this step alone until the backward's recomputes end
        with self.model_ctx.exclusive(), self._checkpointed_blocks(module, names):
            loss, aux = loss_call(leaf, generator) if names else self._region(loss_call, leaf, generator)
            end = generator.get_state() if generator is not None else None
            loss.backward()
        if end is not None:
            generator.set_state(end)
        return loss, aux

    @contextlib.contextmanager
    def _checkpointed_blocks(self, module: torch.nn.Module, names):
        """Each named submodule's forward as a checkpointed region, bound
        to the parameters and buffers the block holds when it runs."""
        blocks = [module.get_submodule(name) for name in names]
        for block in blocks:
            block.forward = functools.partial(self._block_region, block, block.forward)
        try:
            yield
        finally:
            for block in blocks:
                del block.forward

    def _block_region(self, block, forward, *args, **kwargs):
        # the tensors the forward binds (the loss call's compute-dtype casts)
        tensors = block.state_dict(keep_vars=True)

        def call(*args, **kwargs):
            with torch.nn.utils.stateless._reparametrize_module(block, tensors):
                return forward(*args, **kwargs)

        return self._region(call, *args, **kwargs)

    def _region(self, fn, *args, **kwargs):
        """``fn`` checkpointed under the engine's policy; a generator among
        its arguments is set to its entry state on each pass."""
        generator = next((a for a in (*args, *kwargs.values()) if isinstance(a, torch.Generator)), None)
        start = generator.get_state() if generator is not None else None

        def call(*args):
            if start is not None:
                generator.set_state(start)
            return fn(*args, **kwargs)

        context = {}
        if self.remat == "dots":
            context["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(call, *args, use_reentrant=False, preserve_rng_state=False, **context)

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
            metrics = self.train_step(flat_params, opt_state, select_batch(batches, i), count, generator)
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
            _, aux = self.model_ctx.loss(params, select_batch(batches, i))
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
        inputs = batches["input"]
        for i in range(batches["mask"].shape[0]):
            x = {k: v[i] for k, v in inputs.items()} if isinstance(inputs, dict) else inputs[i]
            logits = self.model_ctx.apply(cast(params), cast(x))
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
