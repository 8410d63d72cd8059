"""The per-step distributed SGD client (the port's copy of the JAX
package's ``worker/gradient_worker.py``): an ``OPTIMIZER_STEP`` hook
takes the gradient of each batch at the shared parameters (plus
``weight_decay`` times them), ships it through :meth:`_process_gradient`
(``sign`` for sign-SGD) as ONE flat tensor that stays on the device, waits
for the server's aggregate and applies ``v = momentum * v + g``, ``p = p -
lr(step) * v`` itself (:func:`sgd_update`); the step count runs across
epochs.  Every worker starts from ``engine.init_params(seed)``.  After the
round's training it sends ``end_training`` with its final parameters,
which the server evaluates.

The gradient is flat in the port's layout: the vote is elementwise, so
its layout is the wire's only.  One difference from the JAX package: a
worker stops once it has sent ``end_training``.  The JAX worker goes on to
its next round (``round`` > 1) and waits on a server that has stopped."""

import json
import os
from typing import Any

import torch

from ..message import Message, ParameterMessage
from ..ml_type import ExecutorHookPoint, MachineLearningPhase
from ..utils.logging import get_logger
from .client import Client


class GradientWorker(Client):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        assert self.config.optimizer_name.lower() == "sgd"
        self._momentum_buffer: torch.Tensor | None = None
        self._step_count = 0
        self._epoch_stat: dict[int, dict] = {}

    def _before_training(self) -> None:
        super()._before_training()
        dc = self.trainer.dataset_collection
        dc.remove_dataset(phase=MachineLearningPhase.Test)
        dc.remove_dataset(phase=MachineLearningPhase.Validation)
        # every replica starts from the task's seed, not the worker's
        self.trainer.load_parameter_dict(self.trainer.engine.init_params(self.config.seed))
        self.trainer.append_named_hook(ExecutorHookPoint.OPTIMIZER_STEP, "gradient_exchange", self._step)
        self.trainer.append_named_hook(ExecutorHookPoint.AFTER_EPOCH, "record_epoch", self._record)
        self.trainer.append_named_hook(ExecutorHookPoint.AFTER_EXECUTE, "end_training", self._send_end)

    def _process_gradient(self, gradient: torch.Tensor) -> torch.Tensor:
        """Subclass hook: what goes on the wire."""
        return gradient

    def _step(self, executor, batch, step_rng, **kwargs) -> None:
        trainer = executor
        _, grad = trainer.engine.loss_and_grad(trainer.vec, batch, step_rng)
        if self.config.weight_decay:
            grad.add_(trainer.vec * self.config.weight_decay)
        self.send_data_to_server(
            Message(
                in_round=True,
                other_data={"dataset_size": trainer.dataset_size, "gradient": self._process_gradient(grad)},
            )
        )
        result = self._get_data_from_server()
        assert isinstance(result, Message)
        lr = float(trainer.engine.optimizer.schedule(self._step_count))
        self._momentum_buffer = sgd_update(
            trainer.vec, result.other_data["gradient"], self._momentum_buffer, lr, self.config.momentum
        )
        self._step_count += 1

    def _record(self, executor, epoch, epoch_metrics, **kwargs) -> None:
        self._epoch_stat[epoch] = {"loss": epoch_metrics["loss"], "accuracy": epoch_metrics["accuracy"]}
        with open(os.path.join(self.save_dir, "epoch_stat.json"), "wt", encoding="utf8") as f:
            json.dump(self._epoch_stat, f)

    def _send_end(self, **kwargs) -> None:
        # the final parameters ride along: the server records their test
        # metric (the replicas are equal under lockstep updates)
        self.send_data_to_server(
            ParameterMessage(
                end_training=True,
                parameter=self.trainer.get_parameter_dict(),
                dataset_size=self.trainer.dataset_size,
            )
        )
        self._force_stop = True
        get_logger().debug("%s sent end_training", self.name)


@torch.no_grad()
def sgd_update(vec: torch.Tensor, aggregated: torch.Tensor, momentum_buffer, lr: float, momentum: float):
    """``v = momentum * v + g``, ``vec -= lr * v`` in f32, in place (the
    SPMD sign-SGD session's update); returns the new ``v``."""
    if momentum_buffer is None:
        momentum_buffer = torch.zeros_like(aggregated)
    momentum_buffer.mul_(momentum).add_(aggregated)
    vec.sub_(momentum_buffer * lr)
    return momentum_buffer
