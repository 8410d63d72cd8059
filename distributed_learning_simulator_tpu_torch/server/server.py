"""Server base: the central event loop (the port's copy of the JAX
package's ``server/server.py``).  It sweeps the workers for pending
messages, feeds each to ``_process_worker_data``, sends results to the
selected workers (``None`` to the others) or a message of its own to each
worker, and owns the central test ``Inferencer``.

A worker the task has demoted to a permanent dropout (a crashed thread
or a stalled one, under ``fault_tolerance.client_faults_nonfatal``) can
never upload again: the loop takes its ``None`` in its place, once the
worker's last queued message, if any, has been taken.  In buffered mode
(``_greedy_sweep``) the loop drains every queued message of every worker
a sweep, and synthesises a dropped worker's ``None`` only when the next
flush waits on it."""

import json
import os
from functools import cached_property
from typing import Any

from ..engine.executor import Inferencer
from ..executor import Executor
from ..message import Message, ParameterMessage, Params
from ..ml_type import MachineLearningPhase
from ..utils.logging import get_logger
from ..utils.selection import select_workers


class Server(Executor):
    #: buffered mode: drain every queued message a sweep, not one a worker
    #: a cycle (that cadence is the synchronous round barrier)
    _greedy_sweep = False
    #: whether the server runs the fault plan, the update guard and the
    #: round knobs (``min_client_quorum``, ``resume_dir``, buffered mode);
    #: where its JAX twin takes them and ignores them, ``training.py``
    #: refuses them (ROADMAP.md R18)
    _takes_fault_plan = True

    def __init__(self, task_id, endpoint, config=None, task_context=None, **kwargs: Any) -> None:
        name = "server" if task_id is None else f"server of {task_id}"
        super().__init__(config=config, name=name, task_context=task_context)
        self._endpoint = endpoint

    @property
    def received_bytes(self) -> int:
        return self._endpoint.received_bytes

    @property
    def sent_bytes(self) -> int:
        return self._endpoint.sent_bytes

    @property
    def worker_number(self) -> int:
        return self.config.worker_number

    @cached_property
    def tester(self) -> Inferencer:
        ctx = self._task_context
        return Inferencer(
            self.config,
            ctx.dataset_collection,
            ctx.model_ctx,
            ctx.engine,
            phase=MachineLearningPhase.Test,
            seed=self.config.seed,
            name="tester",
        )

    def get_metric(self, parameter_dict: Params | ParameterMessage, keep_performance_logger: bool = True) -> dict:
        """Central inference of ``parameter_dict`` on the test split."""
        if isinstance(parameter_dict, ParameterMessage):
            parameter_dict = parameter_dict.parameter
        self.tester.load_parameter_dict(parameter_dict)
        metric = self.tester.inference()
        if keep_performance_logger:
            get_logger().info(
                "%s test accuracy %.4f loss %.4f (torch)",
                self.tester.visualizer_prefix,
                metric["accuracy"],
                metric["loss"],
            )
        return metric

    def start(self) -> None:
        with self._get_execution_context():
            with open(os.path.join(self.save_dir, "config.json"), "wt", encoding="utf8") as f:
                json.dump({k: v for k, v in vars(self.config).items() if _is_jsonable(v)}, f, default=str)
            self._before_start()
            worker_set: set[int] = set()
            while not self._stopped():
                if not worker_set:
                    worker_set = self._active_workers()
                progressed = False
                dropped = self._dropped_workers() & worker_set
                if self._greedy_sweep:
                    # only the workers the next flush waits on: the drain
                    # below takes real messages as fast as they come
                    dropped &= self.pending_workers()
                for worker_id in sorted(dropped):
                    if self._endpoint.has_data(worker_id):
                        continue  # its last upload first
                    self._process_worker_data(worker_id, None)
                    if not self._greedy_sweep:
                        worker_set.remove(worker_id)
                    progressed = True
                for worker_id in sorted(worker_set):
                    if self._greedy_sweep:
                        while not self._stopped() and self._endpoint.has_data(worker_id):
                            self._process_worker_data(worker_id, self._endpoint.get(worker_id))
                            progressed = True
                    elif self._endpoint.has_data(worker_id):
                        self._process_worker_data(worker_id, self._endpoint.get(worker_id))
                        worker_set.remove(worker_id)
                        progressed = True
                self._raise_if_aborted()
                if not progressed and worker_set and not self._stopped():
                    wakeup = self._endpoint._topology.server_wakeup
                    wakeup.wait(timeout=0.5)
                    wakeup.clear()
            self._endpoint.close()
            self._server_exit()
            get_logger().debug("end server")

    def _before_start(self) -> None:
        pass

    def _active_workers(self) -> set[int]:
        """The workers the loop still expects messages from (the gradient
        server drops each one that has ended)."""
        return set(range(self._endpoint.worker_num))

    def _server_exit(self) -> None:
        pass

    def _dropped_workers(self) -> set[int]:
        """The workers demoted to permanent dropouts under
        ``fault_tolerance.client_faults_nonfatal``."""
        return set(getattr(self._task_context, "dropped_workers", None) or ())

    def pending_workers(self) -> set[int]:
        """The workers the loop still waits on (the aggregation servers say
        which)."""
        return set()

    def _process_worker_data(self, worker_id: int, data: Message | None) -> None:
        raise NotImplementedError

    def _before_send_result(self, result: Message) -> None:
        pass

    def _after_send_result(self, result: Message) -> None:
        pass

    def _send_result(self, result: Message) -> None:
        """``result`` to the selected workers (``None`` to the others), or,
        where its ``other_data`` holds ``worker_result``, each worker its
        own message."""
        self._before_send_result(result=result)
        if "worker_result" in result.other_data:
            for worker_id, data in result.other_data["worker_result"].items():
                self._endpoint.send(worker_id=worker_id, data=data)
        else:
            selected = self._select_workers()
            get_logger().debug("choose workers %s", selected)
            if selected:
                self._endpoint.broadcast(data=result, worker_ids=selected)
            unselected = set(range(self.worker_number)) - selected
            if unselected:
                self._endpoint.broadcast(data=self._unselected_message(result), worker_ids=unselected)
        self._after_send_result(result=result)

    def _unselected_message(self, result: Message) -> Message | None:
        """What a worker left out of ``result``'s broadcast receives: ``None``."""
        return None

    def _select_workers(self) -> set[int]:
        """Random client selection, deterministic in (seed, round): the round
        counter's, or ``_selection_round`` where a server sets one."""
        return select_workers(
            self.config.seed,
            getattr(self, "_selection_round", None) or getattr(self, "_round_number", 0),
            self.worker_number,
            self.config.algorithm_kwargs.get("random_client_number"),
        )

    def _stopped(self) -> bool:
        raise NotImplementedError


def _is_jsonable(value: Any) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
