"""The round state machine over an aggregation algorithm (the port's copy
of the JAX package's ``server/aggregation_server.py``): send the initial
model, gather every worker's message each round, aggregate, evaluate the
aggregate on the test split, append a row to ``server/round_record.json``
and save ``aggregated_model/round_N.npz`` in the JAX package's keys and
layouts.  With ``need_init_performance`` (the Shapley servers) the
initial model is evaluated and recorded as round 0.

Fault tolerance (``util/faults.py``), as in the JAX server:

* **quorum**: a round whose surviving uploads (not skipped, not rejected
  by the update guard) fall below ``min_client_quorum`` raises
  :class:`~..util.faults.QuorumLostError`; any active fault machinery
  (injection, ``client_faults_nonfatal``, the guard) sets a floor of 1;
* **fault columns**: under that machinery each row carries
  ``rejected_updates`` and ``dropped_clients``, and the trace a ``fault``
  event;
* **kills**: a scheduled ``kill_after_rounds`` arms at its round and
  fires (:class:`~..util.faults.SimulatedPreemption`) once a checkpoint
  at or past it is saved, so a resumed run starts past it;
* **resume**: ``algorithm_kwargs.resume_dir`` restores the newest
  resumable round's parameters and record rows (``util/resume.py``), and
  the initial broadcast tells the workers the round to go on from, those
  it leaves out included (:meth:`AggregationServer._unselected_message`),
  and selects them as the uninterrupted run's result of the round before
  would have (the JAX server selects with the resumed round and tells the
  others nothing, so under ``random_client_number`` its resumed run
  stalls: ROADMAP R19);
* **stall demotion**: :meth:`AggregationServer.pending_workers` names the
  workers the round still waits on, which the watchdog demotes under
  ``client_faults_nonfatal``.

``aggregation_mode: buffered`` (``util/buffered.py``) takes the round
barrier away: the loop drains uploads as they come (``_greedy_sweep``),
holds each keyed by ``(worker, origin round)`` normalised against its
origin's global (a stale delta is restored onto the global it trained
from, kept in ``_param_history`` over the schedule's staleness window),
and flushes as soon as the seeded arrival schedule's cohort for the
round is in.  A flush guards each upload against its origin's global and
averages the survivors with ``dataset_size × 1/(1+staleness)^alpha``
weights, normalised, through kernel K1: one launch a non-empty flush.  An
empty flush keeps the old global.  A buffered resume drains the buffer:
the workers restart at the resumed round, and every scheduled item of an
earlier origin counts as cancelled.  A server whose ``_buffered_capable``
is False, or whose method is not a FedAvg merge, raises the JAX
package's ``ValueError`` on ``aggregation_mode: buffered``.

Telemetry (``util/telemetry.py``) speaks the SPMD sessions' schema, as the
JAX server does: an ``upload`` event a worker message, a ``round_barrier``
span (first upload to the last worker in; buffered: ``buffer_flush``, and
a ``staleness`` event a stale upload merged), and a ``round`` span a
record row (its offset the row's ``trace_offset``; ``init_eval`` for
round 0's row), all on the server thread from host state it owns.  The
``profile_rounds`` window opens at the first upload of its first round
and closes after its last round's record.  The server loop closes the
recorder only on its clean path, so each record is flushed as it is made
unless ``telemetry.flush_every`` says otherwise."""

import os
import time
from typing import Any

import numpy as np
import torch

from ..algorithm.aggregation_algorithm import AggregationAlgorithm, check_finite, update_passes_guard
from ..message import DeltaParameterMessage, Message, ParameterMessage, ParameterMessageBase, Params
from ..models.convert import from_jax, to_jax
from ..ops.pytree import ParamVecLayout, flat_stack_weighted_sum, k1_stack
from ..util.buffered import BufferedSettings, compute_arrival_schedule, threaded_buffered_reason, threaded_uploaders
from ..util.checkpoint import atomic_json_dump
from ..util.faults import FaultPlan, QuorumLostError
from ..util.model_cache import ModelCache
from ..util.resume import load_resume_state
from ..util.telemetry import TraceRecorder
from ..utils.logging import get_logger
from .server import Server


class AggregationServer(Server):
    #: whether the server can run ``aggregation_mode: buffered``: the
    #: servers that own their rounds (FedOBD's phases, Shapley sampling,
    #: the graph exchanges) refuse the knob with the JAX package's ValueError
    _buffered_capable = True

    def __init__(self, algorithm: AggregationAlgorithm, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._model_cache = ModelCache()
        self._round_number = 1
        #: the round the next broadcast selects with (None: ``_round_number``)
        self._selection_round: int | None = None
        self._worker_flag: set[int] = set()
        self.__algorithm = algorithm
        self.__algorithm.set_server(self)
        self.__algorithm.set_config(self.config)
        self.__stat: dict[int, dict] = {}
        self._compute_stat = True
        self.need_init_performance = False
        self.__plateau = 0
        self.__best_acc = 0.0
        self.__max_acc = 0.0
        self.__early_stop = self.config.algorithm_kwargs.get("early_stop", False)
        self._fault_plan = FaultPlan.from_config(self.config)
        self._min_quorum = int(self.config.algorithm_kwargs.get("min_client_quorum", 0) or 0)
        #: the earliest scheduled kill reached but not fired yet
        self._kill_armed_round: int | None = None
        self._last_saved_key = 0
        self.__round_start = time.monotonic()
        self.__round_start_bytes = (0, 0)
        device = getattr(getattr(self._task_context, "model_ctx", None), "device", None)
        self._trace = TraceRecorder.from_config(self.config, default_dir=self.save_dir, device=device)
        if not (self.config.telemetry or {}).get("flush_every"):
            # no try/finally wraps the server loop: flush every record, as
            # the record itself is written every round (an explicit 0 means
            # "auto" and gets the same eager default)
            self._trace.flush_every = 1
        self._upload_window_start: float | None = None
        self._init_buffered()

    def _init_buffered(self) -> None:
        self._buffered = BufferedSettings.from_config(self.config)
        self._buffered_round_stats: dict | None = None
        self._flush_window_start: float | None = None
        if self._buffered is None:
            return
        if not self._buffered_capable:
            reason = f"{type(self).__name__} owns its own round/phase progression"
        else:
            reason = threaded_buffered_reason(self.config.distributed_algorithm)
        if reason is not None:
            raise ValueError(
                f"algorithm_kwargs.aggregation_mode=buffered is unsupported here: {reason} — drop the knob for"
                " this server"
            )
        self._bsched = compute_arrival_schedule(
            self._buffered, self._fault_plan, self.worker_number, self.config.round, threaded_uploaders(self.config)
        )
        self._greedy_sweep = True
        #: (worker, origin) -> (its upload as a full ParameterMessage, its origin's global)
        self._held: dict[tuple[int, int], tuple] = {}
        #: scheduled items whose upload never comes (a dropout's, a dead
        #: worker's or an unselected round's None)
        self._cancelled: set[tuple[int, int]] = set()
        #: each worker's next collection round: every message advances it
        self._origin_counter = {w: 1 for w in range(self.worker_number)}
        #: origins below it trained before a resume and never arrive
        self._buffered_origin_floor = 1
        #: round -> that flush's global: the base a round-o upload diffs against is v_{o-1}
        self._param_history: dict[int, Params] = {}

    @property
    def early_stop(self) -> bool:
        return self.__early_stop

    @property
    def algorithm(self) -> AggregationAlgorithm:
        return self.__algorithm

    @property
    def round_number(self) -> int:
        return self._round_number

    @property
    def performance_stat(self) -> dict[int, dict]:
        return self.__stat

    def _get_init_model(self) -> Params:
        resumed = self._try_resume()
        if resumed is None:
            init_path = self.config.algorithm_kwargs.get("global_model_path")
            if not init_path:
                return self.tester.get_parameter_dict()
            with np.load(init_path) as blob:
                resumed = {k: blob[k] for k in blob.files}
        return {k: v.to(self.tester.device) for k, v in from_jax(resumed).items()}

    def _try_resume(self) -> dict | None:
        """With ``algorithm_kwargs.resume_dir``: its newest resumable round's
        JAX-keyed parameters, its record rows restored and the round counter
        set past it (None: nothing to resume)."""
        resume_dir = self.config.algorithm_kwargs.get("resume_dir")
        if not resume_dir:
            return None
        params, stats, last_round = load_resume_state(resume_dir)
        if params is None:
            get_logger().warning("nothing resumable under %s", resume_dir)
            return None
        self.__stat.update(stats)
        if self.__stat:
            self.__best_acc = self.__max_acc = max(t["test_accuracy"] for t in self.__stat.values())
        self._round_number = last_round + 1
        self._last_saved_key = last_round  # the kill deferral: already durable
        if self._buffered is not None:
            # a buffered resume drains the buffer: the workers restart at the
            # resumed round, and no flush waits on an upload from before the kill
            self._origin_counter = {w: self._round_number for w in range(self.worker_number)}
            self._buffered_origin_floor = self._round_number
        get_logger().info("resumed from %s at round %d", resume_dir, self._round_number)
        return params

    def _init_annotations(self) -> dict:
        """Extra ``other_data`` of the initial broadcast (FedOBD announces a
        resume into phase 2)."""
        return {}

    def _before_start(self) -> None:
        if self.config.distribute_init_parameters:
            parameter = self._get_init_model()
            other_data: dict = {"init": True}
            if self._round_number > 1:  # resumed: the workers go on from here
                other_data["round"] = self._round_number
            other_data.update(self._init_annotations())
            if self._round_number > 1:
                # the workers the uninterrupted run's last result went to
                self._selection_round = self._round_number - 1
            self._send_result(
                ParameterMessage(
                    in_round=True,
                    parameter=parameter,
                    other_data=other_data,
                    is_initial=True,
                    # a resume of a finished schedule has nothing to run
                    end_training=self._stopped(),
                )
            )
            self._selection_round = None

    def _unselected_message(self, result: Message) -> Message | None:
        """A resumed run's initial broadcast tells the workers it leaves out
        the round too (a bare ``Message``, no payload), or they would count
        from round 1 and wait at the end for results that never come.
        Otherwise ``None``."""
        if getattr(result, "is_initial", False) and "round" in result.other_data:
            return Message(other_data={"round": result.other_data["round"]})
        return None

    def _server_exit(self) -> None:
        self.__algorithm.exit()
        self._trace.close()

    def _process_worker_data(self, worker_id: int, data: Message | None) -> None:
        if self._buffered is not None:
            self._process_buffered(worker_id, data)
            return
        assert 0 <= worker_id < self.worker_number
        self._trace.maybe_profile_start(self._round_number)
        if self._trace.enabled:
            if not self._worker_flag:
                # the barrier opens at the round's first upload
                self._upload_window_start = time.monotonic()
            self._trace.event("upload", worker=worker_id, round=self._round_number, dropped=data is None)
        self.__algorithm.process_worker_data(
            worker_id=worker_id,
            worker_data=data,
            old_parameter_dict=self._model_cache.parameter_dict,
        )
        self._worker_flag.add(worker_id)
        if len(self._worker_flag) == self.worker_number:
            if self._trace.enabled and self._upload_window_start is not None:
                self._trace.span_record(
                    "round_barrier",
                    time.monotonic() - self._upload_window_start,
                    round=self._round_number,
                    workers=self.worker_number,
                )
                self._upload_window_start = None
            result = self._aggregate_worker_data()
            self._send_result(result)
            self._worker_flag.clear()

    # ------------------------------------------------------------ buffered
    def _process_buffered(self, worker_id: int, data: Message | None) -> None:
        """A message in buffered mode: it advances the worker's origin
        counter; an upload is made whole against its origin's global and
        held until its landing flush; every flush whose cohort is complete
        then fires (several can follow a demotion)."""
        assert 0 <= worker_id < self.worker_number
        self._trace.maybe_profile_start(self._round_number)
        origin = self._origin_counter[worker_id]
        self._origin_counter[worker_id] = origin + 1
        landing = self._bsched.landing.get((worker_id, origin))
        if self._trace.enabled:
            self._trace.event("upload", worker=worker_id, round=origin, dropped=data is None, landing=landing)
        if data is None or not isinstance(data, ParameterMessageBase):
            self._cancelled.add((worker_id, origin))
            if data is None:
                self.algorithm.skipped_workers.add(worker_id)
        elif landing is None:
            get_logger().debug("buffered: worker %s round %s upload lands past the run end — dropped", worker_id, origin)
        else:
            base = self._param_history.get(origin - 1)
            message: Message = data
            match message:
                case DeltaParameterMessage():
                    assert base is not None, f"buffered: no origin global v_{origin - 1} for a stale delta"
                    message = message.restore(base)
                case ParameterMessage():
                    if base is not None:
                        message.complete(base)
            self._held[(worker_id, origin)] = (message, base)
            if self._flush_window_start is None:
                self._flush_window_start = time.monotonic()
        while not self._stopped() and self._buffered_flush_ready():
            self._buffered_flush()

    def _buffered_flush_ready(self) -> bool:
        """Whether this round's flush can fire: every item the schedule
        lands here has arrived or been cancelled (uploads the cohort does
        not hold never block it)."""
        if self._round_number > self.config.round:
            return False
        for item in self._bsched.live_cohort(self._round_number, self._buffered_origin_floor):
            key = (item.worker, item.origin)
            if key not in self._held and key not in self._cancelled:
                return False
        return True

    def _buffered_flush(self) -> None:
        """One flush: the cohort's held uploads, each guarded against its
        origin's global, averaged with normalised ``dataset_size ×
        discount`` weights through K1 (an empty flush keeps the old
        global)."""
        flush_round = self._round_number
        cohort = self._bsched.live_cohort(flush_round, self._buffered_origin_floor)
        algo = self.algorithm
        uploads: list[ParameterMessage] = []
        weights: list[float] = []
        stale_updates = 0
        for item in cohort:
            key = (item.worker, item.origin)
            if key in self._cancelled:
                algo.skipped_workers.add(item.worker)
                continue
            message, base = self._held.pop(key)
            if not update_passes_guard(self._fault_plan, item.worker, message.parameter, base):
                algo.rejected_workers.add(item.worker)
                algo.skipped_workers.add(item.worker)
                continue
            if item.staleness:
                stale_updates += 1
                if self._trace.enabled:
                    self._trace.event(
                        "staleness", round=flush_round, worker=item.worker, origin=item.origin,
                        staleness=item.staleness, discount=round(item.discount, 6),
                    )
            uploads.append(message)
            weights.append(float(message.dataset_size) * item.discount)
        # only an explicit min_client_quorum: an empty flush keeps the old global
        if self._min_quorum and len(uploads) < self._min_quorum:
            text = (
                f"flush {flush_round}: {len(uploads)} surviving buffered arrivals below"
                f" min_client_quorum={self._min_quorum} (cohort {len(cohort)}, rejected"
                f" {sorted(algo.rejected_workers)}) — aborting loudly"
            )
            get_logger().error(text)
            raise QuorumLostError(text)
        if uploads:
            parameter = self._flush_average(uploads, weights)
            end_training = any(u.end_training for u in uploads)
        else:
            get_logger().info("buffered: flush %s has no landed uploads — keeping the previous global", flush_round)
            parameter = dict(self._model_cache.parameter_dict)
            end_training = False
        depth = self._bsched.buffer_depth_after(flush_round, self._buffered_origin_floor)
        if self._trace.enabled and self._flush_window_start is not None:
            self._trace.span_record(
                "buffer_flush", time.monotonic() - self._flush_window_start, round=flush_round,
                cohort=len(cohort), stale_updates=stale_updates, buffer_depth=depth,
            )
            self._flush_window_start = None
        self._buffered_round_stats = {"flush_cohort": len(cohort), "stale_updates": stale_updates, "buffer_depth": depth}
        self._send_result(ParameterMessage(parameter=parameter, end_training=end_training))

    @staticmethod
    def _flush_average(uploads: list[ParameterMessage], weights: list[float]) -> Params:
        """The flush's weighted mean: the uploads as the f32 rows of one
        ``[K, D]`` stack (:func:`~..ops.pytree.k1_stack`), summed by one K1
        launch with the weights normalised on the host."""
        layout = ParamVecLayout.of(uploads[0].parameter)
        stack = k1_stack(len(uploads), layout.size, next(iter(uploads[0].parameter.values())).device)
        for row, upload in zip(stack, uploads):
            row.copy_(layout.flatten(upload.parameter))
            upload.parameter = {}  # release the upload's tensors
        total = sum(weights)
        w = torch.tensor(np.asarray([x / total for x in weights], np.float32), device=stack.device)
        vec = flat_stack_weighted_sum(stack, w)
        check_finite(vec, layout)
        return layout.split(vec)

    # ------------------------------------------------------------ faults
    def pending_workers(self) -> set[int]:
        """The workers the current round (buffered: the next flush's
        missing cohort items) still waits on; the stall watchdog demotes
        them under ``client_faults_nonfatal``."""
        if self._buffered is not None:
            if self._round_number > self.config.round:
                return set()
            return {
                item.worker
                for item in self._bsched.live_cohort(self._round_number, self._buffered_origin_floor)
                if (item.worker, item.origin) not in self._held and (item.worker, item.origin) not in self._cancelled
            }
        return set(range(self.worker_number)) - set(self._worker_flag)

    def _faults_active(self) -> bool:
        plan = self._fault_plan
        return plan is not None and (plan.injection_active or plan.client_faults_nonfatal or plan.update_guard)

    def _quorum_floor(self) -> int:
        """``min_client_quorum``, at least 1 under any active fault
        machinery: a round that lost or rejected every upload raises."""
        return max(self._min_quorum, 1 if self._faults_active() else 0)

    def _aggregate_worker_data(self) -> Message:
        quorum = self._quorum_floor()
        if quorum:
            survivors = len(self.__algorithm.all_worker_data)
            if survivors < quorum:
                text = (
                    f"round {self._round_number}: {survivors} surviving uploads below min_client_quorum={quorum}"
                    f" (skipped: {sorted(self.__algorithm.skipped_workers)},"
                    f" rejected: {sorted(self.__algorithm.rejected_workers)}) — aborting the round loudly"
                )
                get_logger().error(text)
                raise QuorumLostError(text)
        return self.__algorithm.aggregate_worker_data()

    # ------------------------------------------------------------ results
    def _before_send_result(self, result: Message) -> None:
        if not isinstance(result, ParameterMessageBase):
            return
        assert isinstance(result, ParameterMessage)
        initial = "init" in result.other_data
        if self.need_init_performance and initial:
            # the row keyed 0 (the Shapley engines' round-0 metric)
            self.__record_compute_stat(result.parameter, keep_performance_logger=False, stat_key=0)
        elif self._compute_stat and not initial:
            self.__record_compute_stat(result.parameter)
            self._maybe_early_stop(result)
        elif result.end_training and not initial:
            self.__record_compute_stat(result.parameter)
        # the checkpoint is keyed by the record row just written (FedOBD's
        # in-round aggregates append rows while the round counter stands)
        recorded_key = max((k for k in self.__stat if k > 0), default=self._round_number)
        model_path = os.path.join(self.config.save_dir, "aggregated_model", f"round_{recorded_key}.npz")
        self._model_cache.cache_parameter_dict(result.parameter, model_path)
        if self._buffered is not None:
            # the restore bases: v_r keyed by the flush that made it (the
            # initial broadcast keys the round before the first flush)
            key = self._round_number - 1 if initial else self._round_number
            self._param_history[key] = {k: v.clone() for k, v in result.parameter.items()}
            window = self._bsched.max_staleness + 1
            for old in [k for k in self._param_history if k < key - window]:
                del self._param_history[old]
        if self.config.checkpoint_every_round:
            every = max(1, int(self.config.checkpoint_every or 1))
            if (
                every == 1
                or recorded_key % every == 0
                or recorded_key >= self.config.round
                or result.end_training
            ):
                self._model_cache.save()
                self._last_saved_key = recorded_key

    def _after_send_result(self, result: Message) -> None:
        if isinstance(result, ParameterMessageBase) and not result.in_round:
            self._trace.maybe_profile_stop(self._round_number)
            self._round_number += 1
            if self._fault_plan is not None:
                # a kill arms at its round and fires once a checkpoint at or
                # past it is saved (the rows are written every round)
                completed = self._round_number - 1
                self._kill_armed_round = self._fault_plan.arm_kill(completed, completed, self._kill_armed_round)
                self._fault_plan.fire_armed_kill(self._kill_armed_round, self._last_saved_key)
        self.__algorithm.clear_worker_data()

    def _stopped(self) -> bool:
        return self._round_number > self.config.round

    def _get_stat_key(self) -> int:
        return self._round_number

    def _annotate_stat(self, round_stat: dict) -> None:
        """Subclass hook: extra fields on each round record."""

    def __record_compute_stat(
        self, parameter_dict: Params, keep_performance_logger: bool = True, stat_key: int | None = None
    ) -> None:
        self.tester.set_visualizer_prefix(f"round: {self._round_number},")
        metric = self.get_metric(parameter_dict, keep_performance_logger=keep_performance_logger)
        round_stat = {f"test_{k}": v for k, v in metric.items()}
        now = time.monotonic()
        round_stat["round_seconds"] = now - self.__round_start
        round_stat["received_mb"] = (self.received_bytes - self.__round_start_bytes[0]) / 1e6
        round_stat["sent_mb"] = (self.sent_bytes - self.__round_start_bytes[1]) / 1e6
        self.__round_start = now
        self.__round_start_bytes = (self.received_bytes, self.sent_bytes)
        if self._faults_active():
            # the guard's rejections, and the selected clients that dropped
            # (injected, crashed or demoted by the watchdog)
            algo = self.__algorithm
            round_stat["rejected_updates"] = len(algo.rejected_workers)
            dead = set(getattr(self._task_context, "dropped_workers", None) or ())
            injected = self._fault_plan.dropped_clients(self._round_number, self.worker_number)
            round_stat["dropped_clients"] = len(algo.skipped_workers & (dead | set(injected)))
        if self._buffered is not None and self._buffered_round_stats:
            round_stat.update(self._buffered_round_stats)
        self._annotate_stat(round_stat)
        key = self._get_stat_key() if stat_key is None else stat_key
        assert key not in self.__stat
        if self._trace.enabled:
            if "rejected_updates" in round_stat:
                self._trace.event(
                    "fault", round=key, rejected_updates=round_stat["rejected_updates"],
                    dropped_clients=round_stat.get("dropped_clients", 0),
                )
            fields = {
                "round": key,
                "accuracy": metric.get("accuracy"),
                "loss": metric.get("loss"),
                "received_mb": round_stat["received_mb"],
                "sent_mb": round_stat["sent_mb"],
            }
            if "rejected_updates" in round_stat:
                fields["rejected_updates"] = round_stat["rejected_updates"]
            # round 0's row is not a round: a kind of its own
            round_stat["trace_offset"] = self._trace.span_record(
                "round" if key else "init_eval", round_stat["round_seconds"], **fields
            )
        self.__stat[key] = round_stat
        # the spans first, so a durable row never cross-links a line a
        # resumed recorder would number again
        self._trace.flush()
        atomic_json_dump(os.path.join(self.save_dir, "round_record.json"), self.__stat)
        max_acc = max(t["test_accuracy"] for t in self.__stat.values())
        if max_acc > self.__best_acc:
            self.__best_acc = max_acc
            np.savez(os.path.join(self.save_dir, "best_global_model.npz"), **to_jax(parameter_dict))

    def _maybe_early_stop(self, result: Message) -> None:
        """Plateau stop after each recorded round (FedOBD's driver owns its
        own and overrides this)."""
        if not result.end_training and self.early_stop and self._convergent():
            result.end_training = True

    def _convergent(self) -> bool:
        """A 5-round accuracy plateau."""
        max_acc = max(t["test_accuracy"] for t in self.performance_stat.values())
        if max_acc > self.__max_acc + 0.001:
            self.__max_acc = max_acc
            self.__plateau = 0
            return False
        self.__plateau += 1
        get_logger().info("plateau %s (max acc %.4f)", self.__plateau, self.__max_acc)
        return self.__plateau >= 5
