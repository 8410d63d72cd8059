"""Trainer and Inferencer of the threaded executor (the port's copy of the
JAX package's ``engine/executor.py``).

Each holds its parameters as ONE flat f32 vector on the device
(``ops/pytree.py``) and runs the port's :class:`ComputeEngine` over it:
the trainer epoch by epoch with the hook points the roles register
(``ExecutorHookPoint``), the inferencer over the test split.  Batches are
built on the host per epoch (``engine/batching.py``), shuffled by
``np.random.default_rng(seed * 100003 + epoch_counter)`` as in the JAX
package, and staged on the device.  A trainer armed with
:meth:`Trainer.set_round_stream` trains one round in sampler order with
the SPMD session's dropout generator for ``(seed, round, worker)`` and
reserves that round's :class:`~..ops.quantization.SessionKey` for the
worker's upload transform.

A hook at ``BEFORE_BATCH``, ``AFTER_BATCH`` or ``OPTIMIZER_STEP`` runs
the epoch a batch at a time (the JAX package's per-step program): each
fires once a batch with the JAX keyword arguments (``batch``,
``batch_index``; ``step_rng`` at ``OPTIMIZER_STEP``, the epoch's dropout
generator, which the JAX package splits a key a step from; ``batch_size``
at ``AFTER_BATCH``).  An ``OPTIMIZER_STEP`` hook owns the parameter
update, and the batch's metrics are then taken at the updated parameters
in eval mode, as in JAX.  Without such a hook the per-step epoch takes the
engine's steps in ``train_epoch``'s order, and an epoch without any of
these hooks is ``train_epoch`` itself.
"""

import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from ..data.collection import DatasetCollection
from ..message import Params
from ..ml_type import ExecutorHookPoint, MachineLearningPhase, StopExecutingException
from ..models.dropout import dropout_generator
from ..models.registry import ModelContext
from ..ops.quantization import SessionKey
from ..parallel.spmd import loss_counts
from ..utils.logging import get_logger
from .batching import make_epoch_batches, stage_batches
from .engine import ComputeEngine, maybe_slow_metrics, summarize_metrics
from .hyper_parameter import HyperParameter

#: dropout-generator tag of the unaligned per-epoch stream
_EPOCH_STREAM = 0x5EED
_PER_STEP_POINTS = (
    ExecutorHookPoint.BEFORE_BATCH,
    ExecutorHookPoint.AFTER_BATCH,
    ExecutorHookPoint.OPTIMIZER_STEP,
)


class PerformanceMetric:
    def __init__(self) -> None:
        self.epoch_metrics: dict[int, dict[str, float]] = {}

    def record(self, epoch: int, metrics: dict[str, float]) -> None:
        self.epoch_metrics[epoch] = metrics

    @property
    def last(self) -> dict[str, float]:
        return self.epoch_metrics[max(self.epoch_metrics)] if self.epoch_metrics else {}


class ExecutorBase:
    """What the trainer and the inferencer share: the flat parameters, the
    dataset and the batches."""

    def __init__(
        self,
        config,
        dataset_collection: DatasetCollection,
        model_ctx: ModelContext,
        engine: ComputeEngine,
        phase: MachineLearningPhase,
        seed: int = 0,
        name: str = "",
    ) -> None:
        self.config = config
        self.dataset_collection = dataset_collection
        self.model_ctx = model_ctx
        self.engine = engine
        self.phase = phase
        self.name = name
        self._seed = seed
        self._vec: torch.Tensor | None = None
        self.performance_metric = PerformanceMetric()
        self.visualizer_prefix = ""

    @property
    def device(self) -> torch.device:
        return self.model_ctx.device

    @property
    def hyper_parameter(self) -> HyperParameter:
        return self.engine.hyper_parameter

    @property
    def vec(self) -> torch.Tensor:
        """The flat f32 parameters (a fresh init from the seed until a
        parameter dict is loaded)."""
        if self._vec is None:
            params = self.engine.init_params(self._seed)
            self._vec = self.engine.layout.flatten(
                {k: v.to(self.device, torch.float32) for k, v in params.items()}
            )
        return self._vec

    @property
    def params(self) -> Params:
        """Views of :attr:`vec`, shaped like the model's tensors."""
        return self.engine.layout.split(self.vec)

    def get_parameter_dict(self) -> Params:
        """A snapshot: views of one copy of :attr:`vec` (training goes on in
        place)."""
        return self.engine.layout.split(self.vec.clone())

    def load_parameter_dict(self, params: Params) -> None:
        self._vec = self.engine.layout.flatten(
            {k: v.to(self.device) for k, v in params.items()}
        )

    @property
    def dataset_size(self) -> int:
        return self.dataset_collection.dataset_size(self.phase)

    def set_visualizer_prefix(self, prefix: str) -> None:
        self.visualizer_prefix = prefix

    def epoch_batches(self, phase: MachineLearningPhase, shuffle_seed: int | None):
        """``(staged batches, host loss counts)`` of one epoch of ``phase``."""
        dataset = self.dataset_collection.get_dataset(phase)
        rng = None if shuffle_seed is None else np.random.default_rng(shuffle_seed)
        host = make_epoch_batches(dataset, self.hyper_parameter.batch_size, rng)
        staged = stage_batches(host, self.model_ctx.compute_dtype, self.device)
        return staged, loss_counts(self.model_ctx, host)


class Trainer(ExecutorBase):
    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, phase=MachineLearningPhase.Training, **kwargs)
        self._hooks: dict[ExecutorHookPoint, dict[str, Callable]] = {}
        self._opt_state = None
        self._epoch_counter = 0  # epochs across rounds
        self._round_stream: tuple[int, int, int] | None = None
        #: the key the aligned stream reserved this round (None unarmed)
        self.reserved_quant_key: SessionKey | None = None
        self.batch_loss_log_enabled = True

    def set_round_stream(self, stream: tuple[int, int, int]) -> None:
        """Arm the next :meth:`train` call with the SPMD session's stream
        for ``(seed, round, worker)``: sampler-order batches every epoch,
        the session's dropout generator, and the session's draws of that
        client's upload in aggregate ``round - 1`` as
        :attr:`reserved_quant_key`.  One-shot."""
        self._round_stream = stream

    # --- hooks
    def append_named_hook(self, hook_point: ExecutorHookPoint, name: str, fn: Callable) -> None:
        self._hooks.setdefault(hook_point, {})[name] = fn

    def remove_named_hook(self, name: str, hook_point: ExecutorHookPoint | None = None) -> None:
        for point in [hook_point] if hook_point else list(self._hooks):
            self._hooks.get(point, {}).pop(name, None)

    def has_hook(self, hook_point: ExecutorHookPoint) -> bool:
        return bool(self._hooks.get(hook_point))

    def _fire(self, hook_point: ExecutorHookPoint, **kwargs) -> None:
        for fn in list(self._hooks.get(hook_point, {}).values()):
            fn(executor=self, hook_point=hook_point, **kwargs)

    # --- optimizer state
    @property
    def opt_state(self):
        if self._opt_state is None:
            self._opt_state = self.engine.init_opt_state(self.vec)
        return self._opt_state

    def load_parameter_dict(self, params: Params, reuse_learning_rate: bool = False) -> None:
        """Loading new global parameters starts a fresh optimizer unless
        the learning-rate state is reused (FedOBD's second phase)."""
        super().load_parameter_dict(params)
        if not reuse_learning_rate:
            self._opt_state = None

    # --- the round's local training
    def train(self) -> None:
        self._fire(ExecutorHookPoint.BEFORE_EXECUTE)
        per_step = any(self.has_hook(p) for p in _PER_STEP_POINTS)
        aligned, self._round_stream = self._round_stream, None
        round_generator = None
        self.reserved_quant_key = None
        if aligned is not None:
            round_generator = dropout_generator(*aligned, self.device)
            seed, round_number, worker = aligned
            self.reserved_quant_key = SessionKey(seed, round_number - 1, worker)
        try:
            for epoch in range(1, self.hyper_parameter.epoch + 1):
                start = time.monotonic()
                self._epoch_counter += 1
                shuffle_seed = None if aligned is not None else self._seed * 100003 + self._epoch_counter
                batches, counts = self.epoch_batches(self.phase, shuffle_seed)
                self._fire(ExecutorHookPoint.BEFORE_EPOCH, epoch=epoch)
                generator = round_generator
                if generator is None:
                    generator = dropout_generator(self._seed, self._epoch_counter, _EPOCH_STREAM, self.device)
                if per_step:
                    summed = self._train_epoch_per_step(batches, counts, epoch, generator)
                else:
                    summed = self.engine.train_epoch(self.vec, self.opt_state, batches, counts, generator)
                metrics = summarize_metrics(summed)
                metrics["duration"] = time.monotonic() - start
                self.performance_metric.record(self._epoch_counter, metrics)
                if self.batch_loss_log_enabled or self.config.debug:
                    get_logger().info(
                        "%s epoch %d loss %.4f acc %.4f (%.2fs)",
                        self.visualizer_prefix or self.name,
                        epoch,
                        metrics["loss"],
                        metrics["accuracy"],
                        metrics["duration"],
                    )
                self._fire(ExecutorHookPoint.AFTER_EPOCH, epoch=epoch, epoch_metrics=metrics)
            self._fire(ExecutorHookPoint.AFTER_EXECUTE)
        except StopExecutingException:
            get_logger().debug("%s stopped by hook", self.name)

    def _train_epoch_per_step(self, batches: dict, counts, epoch: int, generator) -> dict:
        """One epoch a batch at a time with the per-step hooks; the summed
        metrics stay on the device."""
        summed = {k: torch.zeros((), device=self.device) for k in ("loss_sum", "correct", "count")}
        for i, count in enumerate(counts):
            batch = {k: v[i] for k, v in batches.items()}
            self._fire(ExecutorHookPoint.BEFORE_BATCH, epoch=epoch, batch_index=i, batch=batch)
            if self.has_hook(ExecutorHookPoint.OPTIMIZER_STEP):
                self._fire(ExecutorHookPoint.OPTIMIZER_STEP, epoch=epoch, batch_index=i, batch=batch,
                           step_rng=generator)
                result = self.engine.evaluate(self.params, {k: v[i : i + 1] for k, v in batches.items()})
                for key in summed:
                    summed[key] += result[key]
            else:
                metrics = self.engine.train_step(self.vec, self.opt_state, batch, count, generator)
                if metrics is not None:
                    summed["loss_sum"] += metrics["loss"] * metrics["count"]
                    summed["correct"] += metrics["correct"]
                    summed["count"] += metrics["count"]
            self._fire(ExecutorHookPoint.AFTER_BATCH, epoch=epoch, batch_index=i, batch=batch,
                       batch_size=float(count))
        return summed


class Inferencer(ExecutorBase):
    def __init__(self, *args, phase=MachineLearningPhase.Test, **kwargs) -> None:
        super().__init__(*args, phase=phase, **kwargs)
        self._cached_batches: Any = None

    def _eval_batches(self):
        """The split's batches, staged once and kept on the device unless
        ``cache_transforms`` is ``none`` (the split and its order are
        fixed)."""
        if str(self.config.cache_transforms or "none").lower() == "none":
            return self.epoch_batches(self.phase, None)[0]
        if self._cached_batches is None:
            self._cached_batches = self.epoch_batches(self.phase, None)[0]
        return self._cached_batches

    def inference(self) -> dict[str, float]:
        batches = self._eval_batches()
        metrics = summarize_metrics(self.engine.evaluate(self.params, batches))
        metrics.update(maybe_slow_metrics(self.config, self.engine, self.params, batches))
        self.performance_metric.record(len(self.performance_metric.epoch_metrics) + 1, metrics)
        return metrics
