"""Worker base: one client's round loop on its own thread (the port's copy
of the JAX package's ``worker/worker.py``).  A worker runs
``trainer.train()`` once a round until its round counter passes
``config.round`` or it is stopped; its role's hooks fire from the
trainer's hook points.

``parallel_number`` bounds how many workers train at once: a worker takes
one of the task's ``train_slots`` (a semaphore) before it trains and
gives it back while it waits on the server (``worker/client.py``), so a
round barrier over every worker never waits on a slot held by a waiter."""

import dataclasses
import json
import os
from functools import cached_property
from typing import Any

from ..engine.executor import Trainer
from ..executor import Executor
from ..utils.logging import get_logger


class Worker(Executor):
    def __init__(self, task_id, endpoint, practitioner, config=None, task_context=None, **kwargs: Any) -> None:
        worker_id = practitioner.worker_id
        name = f"worker {worker_id}" if task_id is None else f"worker {worker_id} of {task_id}"
        super().__init__(config=config, name=name, task_context=task_context)
        self._practitioner = practitioner
        self._endpoint = endpoint
        self._round_num = 0
        self._force_stop = False
        self._holds_slot = False
        self._slot_deferred = False  # a slot owed after an unselected round

    @property
    def worker_id(self) -> int:
        return self._practitioner.worker_id

    @cached_property
    def trainer(self) -> Trainer:
        ctx = self._task_context
        trainer = Trainer(
            self.config,
            ctx.worker_dataset_collection(self._practitioner),
            ctx.model_ctx,
            ctx.engine,
            seed=self.config.seed + self.worker_id + 1,
            name=self.name,
        )
        trainer.batch_loss_log_enabled = False
        return trainer

    def _offload_from_device(self) -> None:
        pass

    def _before_round(self) -> None:
        """Runs before each round's local training."""

    def _before_training(self) -> None:
        pass

    def _after_training(self) -> None:
        with open(os.path.join(self.save_dir, "hyper_parameter.json"), "wt", encoding="utf8") as f:
            json.dump(dataclasses.asdict(self.trainer.hyper_parameter), f)
        if self.config.save_performance_metric:
            with open(os.path.join(self.save_dir, "performance_metric.json"), "wt", encoding="utf8") as f:
                json.dump(self.trainer.performance_metric.epoch_metrics, f)

    def _stopped(self) -> bool:
        return self._round_num > self.config.round or self._force_stop

    def _train_slots(self):
        return getattr(self._task_context, "train_slots", None)

    def _acquire_slot(self) -> None:
        slots = self._train_slots()
        if slots is None or self._holds_slot:
            return
        while not slots.acquire(timeout=0.5):
            self._raise_if_aborted()
        self._holds_slot = True

    def _release_slot(self) -> None:
        slots = self._train_slots()
        if slots is not None and self._holds_slot:
            self._holds_slot = False
            slots.release()

    def start(self) -> None:
        first_training = True
        self._round_num = 1
        self._force_stop = False
        with self._get_execution_context():
            try:
                while not self._stopped():
                    if first_training:
                        self._before_training()
                        first_training = False
                        if self._stopped():
                            break
                    self.trainer.set_visualizer_prefix(f"round: {self._round_num},")
                    self._before_round()
                    self._acquire_slot()
                    self.trainer.train()
                    self._round_num += 1
            finally:
                self._release_slot()
            get_logger().debug("finish %s", self.name)
            self._endpoint.close()
            self._after_training()
