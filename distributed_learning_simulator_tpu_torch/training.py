"""Task construction and the ``train`` entry point (the port's ``training.py``).

``train(config)`` builds the data, the partitions, the model and the engine
the way the JAX package's ``_build_task`` does, then runs one of two
executors:

* ``executor: auto`` or ``spmd``: the single-device sessions of
  :data:`SPMD_SESSION_BUILDERS`: FedAvg and fed_paq
  (``parallel/spmd.py``), fed_obd and fed_obd_sq
  (``parallel/spmd_obd.py``), fed_dropout_avg and single_model_afd
  (``parallel/spmd_sparse.py``), sign_SGD (``parallel/spmd_sign_sgd.py``),
  the three Shapley-value methods ``GTG_shapley_value``,
  ``multiround_shapley_value`` and ``Hierarchical_shapley_value``
  (``parallel/spmd_shapley.py``), and graph FL: fed_gnn and fed_gcn
  (``share_feature`` forced on) and fed_aas (``parallel/spmd_gnn.py``);
* ``executor: sequential``: the threaded executor, the server and every
  worker on a thread of their own exchanging messages through in-memory
  endpoints: every method the SPMD sessions run (the methods ``method/``
  registers): ``fed_avg``, ``fed_paq``, ``fed_obd`` (NNADQ),
  ``fed_obd_sq``, ``fed_dropout_avg``, ``single_model_afd``, ``sign_SGD``,
  the three Shapley-value methods (``method/shapley_value``: the subset
  metrics through the SPMD session's evaluator, K1 once a subset and once
  a round) and graph FL (``fed_gnn``, ``fed_gcn``, ``fed_aas``: the
  boundary exchange through the server, a barrier of every worker a
  message-passing stage).  fed_avg, fed_paq, fed_dropout_avg,
  single_model_afd, and the FedOBD pair at ``second_phase_epoch: 1``, draw
  what their SPMD sessions draw; the Shapley and graph workers train the
  trainer's own shuffled stream, as the JAX roles do.  A failure on any
  thread sets the task's abort event, every blocking loop unwinds, and
  ``train`` re-raises the first error after joining the threads.

It runs on CUDA unless ``device="cpu"`` is passed (or set in the config),
and raises where no GPU is visible.  What the port does not run yet raises
``NotImplementedError`` naming the ROADMAP item.

``fault_tolerance`` runs on every executor where the JAX package runs it.
The SPMD sessions fold the plan into their weight rows, each taking or
refusing the update guard and ``aggregation_mode: buffered`` as its JAX
twin does (``parallel/spmd.py``).  The threaded executor runs the plan at
the upload (the worker) and the guard, quorum, kills, resume and buffered
flushes at the server (``server/aggregation_server.py``); under
``fault_tolerance.client_faults_nonfatal`` a worker that crashes, or that
the stall watchdog (``watchdog_seconds``) finds holding a round up, becomes
a permanent dropout instead of ending the task; ``parallel_number`` bounds
the workers training at once.  The threaded executor refuses
``float64_parity``, the population store and any other knob its roles do
not read (item 7); on the Shapley, graph and FedOBD servers
``aggregation_mode: buffered`` raises the JAX package's ``ValueError``.
Where a JAX role takes a knob and ignores it, the port refuses it
(ROADMAP.md R18): the fault plan on the graph sessions (beyond the kill
schedule and the supervisor's knobs) and on threaded sign_SGD,
``client_faults_nonfatal`` and ``parallel_number`` on the SPMD sessions,
and resume, the quorum and buffered aggregation on threaded sign_SGD.

:func:`train_with_recovery` is the supervisor: attempt ``k`` runs in
``<save_dir>_retry<k>`` and resumes from the newest attempt directory that
holds a resumable round (``util/resume.py``).  ``__main__`` runs a config
with ``fault_tolerance.auto_resume`` under it.

``telemetry`` (``util/telemetry.py``) runs on every executor but the graph
sessions, which, as the JAX ones, never read it.  ``profile: true`` runs
the whole run (not the task's construction) under ``torch.profiler`` and
writes its Chrome trace under ``<save_dir>/profile``, as the JAX package
wraps the run in ``jax.profiler``.
"""

import contextlib
import copy
import dataclasses
import math
import os
import threading
import time
from typing import Any

import torch

from .config import DistributedTrainingConfig
from .data import DatasetCollection, create_dataset_collection
from .engine.engine import ComputeEngine
from .engine.hyper_parameter import HyperParameter
from .method.algorithm_factory import CentralizedAlgorithmFactory
from .ml_type import MachineLearningPhase as Phase
from .ml_type import TaskAbortedError
from .models import create_model_context
from .models.registry import ModelContext
from .parallel.spmd import SpmdFedAvgSession
from .parallel.spmd_gnn import SpmdFedAASSession, SpmdFedGNNSession
from .parallel.spmd_obd import SpmdFedOBDSession
from .parallel.spmd_shapley import SpmdShapleySession
from .parallel.spmd_sign_sgd import SpmdSignSGDSession
from .parallel.spmd_sparse import SpmdFedDropoutAvgSession, SpmdSMAFDSession
from .practitioner import create_practitioners
from .topology.central_topology import CentralTopology
from .util.faults import FaultPlan
from .util.resume import resumable_round
from .utils.device import resolve_device
from .utils.logging import add_file_handler, get_logger

#: model_kwargs that select a multi-device layout in the JAX package
_LAYOUT_KWARGS = ("sequence_parallel", "expert_parallel", "pipeline_stages")
_EXECUTORS = ("auto", "spmd", "sequential")
_GRAPH_METHODS = ("fed_gnn", "fed_gcn", "fed_aas")
#: algorithm_kwargs the threaded executor's roles read; any other raises
THREADED_ALGORITHM_KWARGS = frozenset(
    {"global_model_path", "random_client_number", "early_stop", "second_phase_epoch", "dropout_rate", "topk_ratio"}
)
_SHAPLEY_KWARGS = frozenset({"choose_best_subset", "sv_kwargs", "part_number", "vp_size"})
_GRAPH_KWARGS = frozenset({"share_feature", "batch_number", "edge_drop_rate", "num_neighbor"})
#: what else each method's threaded roles read
_THREADED_METHOD_KWARGS = {
    **{name: _SHAPLEY_KWARGS for name in ("GTG_shapley_value", "multiround_shapley_value", "Hierarchical_shapley_value")},
    **{name: _GRAPH_KWARGS for name in ("fed_gnn", "fed_gcn", "fed_aas")},
}
#: the buffered knobs, which a server that cannot buffer refuses itself
#: with the JAX package's ValueError
_BUFFERED_KWARGS = frozenset({"aggregation_mode", "buffer_size", "staleness_alpha"})
#: what the threaded AggregationServer reads besides the roles' kwargs
_THREADED_SERVER_KWARGS = frozenset({"resume_dir", "min_client_quorum"})
_R18 = "ROADMAP.md R18: the JAX package takes it and ignores it"


def _session_fed_avg(config, args):
    return SpmdFedAvgSession(*args)


def _session_fed_paq(config, args):
    level = int(config.endpoint_kwargs.get("worker", {}).get("quantization_level", 255))
    return SpmdFedAvgSession(*args, quantization_level=level)


def _session_fed_obd(config, args):
    codec = "qsgd" if config.distributed_algorithm == "fed_obd_sq" else "nnadq"
    return SpmdFedOBDSession(*args, codec=codec)


def _session_fed_dropout_avg(config, args):
    return SpmdFedDropoutAvgSession(*args)


def _session_smafd(config, args):
    return SpmdSMAFDSession(*args)


def _session_sign_sgd(config, args):
    return SpmdSignSGDSession(*args)


def _session_shapley(config, args):
    return SpmdShapleySession(*args)


def _session_fed_gnn(config, args):
    share = True if config.distributed_algorithm == "fed_gcn" else None
    return SpmdFedGNNSession(*args, share_feature=share)


def _session_fed_aas(config, args):
    return SpmdFedAASSession(*args)


#: algorithm name -> SPMD session builder (the JAX package's table, for
#: the methods the port runs on it)
SPMD_SESSION_BUILDERS = {
    "fed_avg": _session_fed_avg,
    "fed_paq": _session_fed_paq,
    "sign_SGD": _session_sign_sgd,
    "fed_obd": _session_fed_obd,
    "fed_obd_sq": _session_fed_obd,
    "fed_gnn": _session_fed_gnn,
    "fed_gcn": _session_fed_gnn,
    "fed_aas": _session_fed_aas,
    "fed_dropout_avg": _session_fed_dropout_avg,
    "single_model_afd": _session_smafd,
    "GTG_shapley_value": _session_shapley,
    "multiround_shapley_value": _session_shapley,
    "Hierarchical_shapley_value": _session_shapley,
}


def resolve_executor(config: DistributedTrainingConfig) -> str:
    """``auto`` is the SPMD session, as for every built-in method of the
    JAX package; ``sequential`` the threaded executor."""
    executor = str(config.executor or "auto")
    if executor not in _EXECUTORS:
        raise ValueError(f"unknown executor {executor!r}; expected one of {_EXECUTORS}")
    return "spmd" if executor == "auto" else executor


def _refuse_unported(config: DistributedTrainingConfig) -> None:
    algorithm = config.distributed_algorithm
    spmd = resolve_executor(config) == "spmd"
    faultless = False
    if spmd:
        if algorithm not in SPMD_SESSION_BUILDERS:
            raise NotImplementedError(
                f"method {algorithm!r} under the SPMD executor is not ported yet (ROADMAP.md);"
                f" the port's SPMD sessions run {sorted(SPMD_SESSION_BUILDERS)}"
            )
    elif not CentralizedAlgorithmFactory.has_algorithm(algorithm):
        raise NotImplementedError(
            f"method {algorithm!r} on the threaded executor is not ported yet;"
            f" it runs {sorted(CentralizedAlgorithmFactory.config)}"
        )
    else:
        accepted = THREADED_ALGORITHM_KWARGS | _THREADED_METHOD_KWARGS.get(algorithm, frozenset())
        # a server whose JAX twin ignores the plan and the round knobs refuses them
        faultless = not CentralizedAlgorithmFactory.config[algorithm].server_cls._takes_fault_plan
        if not faultless:
            # the servers refuse what they cannot buffer themselves (the JAX ValueError)
            accepted |= _BUFFERED_KWARGS | _THREADED_SERVER_KWARGS
        unsupported = sorted(set(config.algorithm_kwargs) - accepted)
        if unsupported:
            ignored = _BUFFERED_KWARGS | _THREADED_SERVER_KWARGS if faultless else frozenset()
            items = [f"{k}: {_R18 if k in ignored else 'ROADMAP.md Queue 1 item 7'}" for k in unsupported]
            raise NotImplementedError(f"algorithm_kwargs are not ported yet on the threaded executor ({items})")
    layouts = [k for k in _LAYOUT_KWARGS if int(config.model_kwargs.get(k, 0) or 0) > 1]
    # the SPMD sessions gate the rest of fault_tolerance per class
    # (parallel/spmd.py); where a JAX role ignores the plan, the port refuses it
    plan = FaultPlan.from_config(config)
    if spmd and algorithm in _GRAPH_METHODS:
        faults_refused = plan is not None and not plan.only_recovery
    elif faultless:
        faults_refused = plan is not None and (plan.injection_active or plan.update_guard)
    else:
        faults_refused = spmd and plan is not None and plan.client_faults_nonfatal
    refused = {
        "model_kwargs": (layouts, "ROADMAP.md Queue 1 item 8"),
        "fault_tolerance": (faults_refused, _R18),
        "parallel_number": (bool(config.parallel_number) and spmd, _R18),
    }
    named = [f"{k} ({item})" for k, (v, item) in refused.items() if v]
    if named:
        raise NotImplementedError(f"{named} are refused on the port")


@dataclasses.dataclass
class _Prepared:
    config: DistributedTrainingConfig
    dataset_collection: DatasetCollection
    practitioners: list
    model_ctx: ModelContext
    engine: ComputeEngine


def _prepare(config: DistributedTrainingConfig, practitioners, device) -> _Prepared:
    """The JAX package's ``_build_task`` up to the engine: data,
    partitions, model and engine, on the device."""
    config = copy.deepcopy(config)
    if device is not None:
        config.device = device
    target = resolve_device(config.device)
    _refuse_unported(config)
    if not config.save_dir:
        config.load_config_and_process()
    if config.log_file:
        add_file_handler(config.log_file)
    dataset_collection = create_dataset_collection(config)
    if practitioners is None:
        practitioners = create_practitioners(config, dataset_collection)
    if len(practitioners) != config.worker_number:
        raise ValueError(f"{len(practitioners)} practitioners for {config.worker_number} workers")
    # as the JAX package's _build_task: the sharding kwargs stop here, the
    # model sees pipeline_stages (the text classifier refuses any nonzero)
    model_kwargs = {
        k: v for k, v in config.model_kwargs.items() if k not in ("sequence_parallel", "expert_parallel")
    }
    model_ctx = create_model_context(config.model_name, dataset_collection, device=target, **model_kwargs)
    if config.use_amp:
        # bf16 compute; the f32 master is cast per step (threaded) or once
        # per round (SPMD)
        model_ctx.compute_dtype = torch.bfloat16
    train_size = dataset_collection.dataset_size(Phase.Training)
    steps_per_epoch = max(1, math.ceil(train_size / config.worker_number / config.batch_size))
    engine = ComputeEngine(
        model_ctx, HyperParameter.from_config(config), total_steps=steps_per_epoch * config.epoch
    )
    return _Prepared(config, dataset_collection, practitioners, model_ctx, engine)


def build_session(
    config: DistributedTrainingConfig, practitioners=None, device: str | None = None
) -> SpmdFedAvgSession:
    """The JAX package's ``_build_task`` + ``_make_spmd_session``: the
    method's session, staged on the device, ready to ``run``."""
    p = _prepare(config, practitioners, device)
    args = (p.config, p.dataset_collection, p.model_ctx, p.engine, p.practitioners)
    return SPMD_SESSION_BUILDERS[p.config.distributed_algorithm](p.config, args)


@dataclasses.dataclass
class TaskContext:
    """What the threaded executor's roles share: one engine, model and
    dataset for all of them, the topology, and the abort machinery."""

    config: DistributedTrainingConfig
    dataset_collection: DatasetCollection
    model_ctx: ModelContext
    engine: ComputeEngine
    topology: CentralTopology
    practitioners: list
    task_id: Any = None
    abort_event: threading.Event = dataclasses.field(default_factory=threading.Event)
    threads: list = dataclasses.field(default_factory=list)
    errors: list = dataclasses.field(default_factory=list)
    server: Any = None
    workers: list = dataclasses.field(default_factory=list)
    #: workers demoted to permanent dropouts (crashed, or stalled past the
    #: watchdog) under ``client_faults_nonfatal``: the server takes their
    #: ``None`` every round
    dropped_workers: set = dataclasses.field(default_factory=set)
    #: ``parallel_number``: at most this many workers train at once (None: any)
    train_slots: Any = None

    def aborted(self) -> bool:
        return self.abort_event.is_set()

    def worker_dataset_collection(self, practitioner) -> DatasetCollection:
        """One worker's view of the data: its partition of every split."""
        sampler = practitioner.get_sampler(self.config.dataset_name)
        return self.dataset_collection.subset(sampler.sample(practitioner.practitioner_id))


def build_task(
    config: DistributedTrainingConfig, practitioners=None, device: str | None = None
) -> TaskContext:
    """The JAX package's ``_build_task`` for the threaded executor."""
    p = _prepare(config, practitioners, device)
    if not CentralizedAlgorithmFactory.has_algorithm(p.config.distributed_algorithm):
        raise NotImplementedError(f"no threaded roles for {p.config.distributed_algorithm!r}")
    return TaskContext(
        config=p.config,
        dataset_collection=p.dataset_collection,
        model_ctx=p.model_ctx,
        engine=p.engine,
        topology=CentralTopology(p.config.worker_number),
        practitioners=sorted(p.practitioners, key=lambda q: q.worker_id),
        train_slots=threading.BoundedSemaphore(p.config.parallel_number) if p.config.parallel_number > 0 else None,
    )


def _spawn(ctx: TaskContext) -> None:
    """Build the server and the workers and start each on its own thread."""
    config = ctx.config
    algorithm = config.distributed_algorithm
    common = {"config": config, "task_context": ctx, "task_id": ctx.task_id}
    ctx.server = CentralizedAlgorithmFactory.create_server(
        algorithm, ctx.topology, endpoint_kwargs=config.endpoint_kwargs.get("server", {}), kwargs=dict(common)
    )
    for practitioner in ctx.practitioners:
        ctx.workers.append(
            CentralizedAlgorithmFactory.create_client(
                algorithm,
                ctx.topology,
                worker_id=practitioner.worker_id,
                endpoint_kwargs=config.endpoint_kwargs.get("worker", {}),
                kwargs={**common, "practitioner": practitioner},
            )
        )

    nonfatal = bool(dict(config.fault_tolerance or {}).get("client_faults_nonfatal"))

    def run(executor) -> None:
        try:
            executor.start()
        except TaskAbortedError:
            get_logger().debug("%s aborted", executor.name)
        except BaseException as exc:  # noqa: BLE001 -- re-raised by run_task
            worker_id = getattr(executor, "worker_id", None)
            if nonfatal and worker_id is not None and isinstance(exc, Exception):
                # a crashed worker becomes a permanent dropout; the server's
                # faults stay fatal (nobody aggregates without it)
                get_logger().warning(
                    "%s failed (%s: %s) — demoted to a dropout (fault_tolerance.client_faults_nonfatal)",
                    executor.name, type(exc).__name__, exc,
                )
                ctx.dropped_workers.add(worker_id)
                ctx.topology.server_wakeup.set()
                return
            get_logger().exception("%s failed", executor.name)
            ctx.errors.append(exc)
            ctx.abort_event.set()
            ctx.topology.server_wakeup.set()

    for executor in [ctx.server, *ctx.workers]:
        ctx.threads.append(threading.Thread(target=run, args=(executor,), name=executor.name, daemon=True))
    for thread in ctx.threads:
        thread.start()
    if config.watchdog_seconds > 0:
        # not one of ctx.threads: run_task does not join it
        threading.Thread(
            target=_watchdog_loop, args=(ctx, config.watchdog_seconds), name="watchdog", daemon=True
        ).start()


def _watchdog_loop(ctx: TaskContext, stall_seconds: float, poll: float = 0.0) -> None:
    """The threaded executor's stall watchdog: when no message moves for
    ``stall_seconds`` (``topology.activity`` stands still), it demotes the
    workers the server's round waits on to dropouts under
    ``client_faults_nonfatal`` and keeps watching, and otherwise (or with
    no worker left to blame) ends the task with a ``TimeoutError``.  Long
    local training between messages is normal, so it watches message
    progress and puts no deadline on any one wait."""
    poll = poll or min(10.0, max(0.5, stall_seconds / 10.0))
    last_activity = ctx.topology.activity
    stall_start = time.monotonic()
    nonfatal = bool(dict(ctx.config.fault_tolerance or {}).get("client_faults_nonfatal"))
    while not ctx.aborted() and any(t.is_alive() for t in ctx.threads):
        time.sleep(poll)
        if ctx.topology.activity != last_activity:
            last_activity = ctx.topology.activity
            stall_start = time.monotonic()
            continue
        stalled = time.monotonic() - stall_start
        if stalled <= stall_seconds:
            continue
        pending_fn = getattr(ctx.server, "pending_workers", None)
        if nonfatal and pending_fn is not None:
            pending = set(pending_fn()) - set(ctx.dropped_workers)
            if pending:
                get_logger().warning(
                    "watchdog: no message progress for %.0fs; demoting stalled workers %s to dropouts"
                    " (fault_tolerance.client_faults_nonfatal)",
                    stalled, sorted(pending),
                )
                ctx.dropped_workers.update(pending)
                ctx.topology.server_wakeup.set()
                stall_start = time.monotonic()
                continue
        waiting = [t.name for t in ctx.threads if t.is_alive()]
        get_logger().error(
            "watchdog: no message progress for %.0fs (threshold %.0fs); aborting task — executors still running: %s",
            stalled, stall_seconds, waiting,
        )
        ctx.errors.append(TimeoutError(f"watchdog: message fabric stalled {stalled:.0f}s; live executors: {waiting}"))
        ctx.abort_event.set()
        ctx.topology.server_wakeup.set()
        return


def run_task(ctx: TaskContext) -> dict:
    """Run a task built by :func:`build_task` on its threads: start the
    server and the workers, join them all, and re-raise the first error
    any of them hit."""
    _spawn(ctx)
    for thread in ctx.threads:
        thread.join()
    if ctx.errors:
        raise ctx.errors[0]
    result = {"performance": ctx.server.performance_stat}
    algorithm = getattr(ctx.server, "algorithm", None)
    if getattr(algorithm, "sv_algorithm", None) is not None:
        result["sv"], result["sv_S"] = algorithm.shapley_values, algorithm.shapley_values_S
    get_logger().info(
        "threaded training done on %s (%d records)", ctx.model_ctx.device, len(result["performance"])
    )
    return _remap_sv(result, ctx.practitioners)


def _remap_sv(result: dict, practitioners) -> dict:
    """The Shapley sessions' per-round dicts keyed by practitioner id, not
    worker id (the JAX package's ``train``)."""
    practitioner_of = {p.worker_id: p.practitioner_id for p in practitioners}
    for key in ("sv", "sv_S"):
        if key in result:
            result[key] = {
                round_number: {practitioner_of[int(w)]: value for w, value in round_sv.items()}
                for round_number, round_sv in result[key].items()
            }
    return result


@contextlib.contextmanager
def _profiled(config: DistributedTrainingConfig, device):
    """With ``config.profile``, the block under ``torch.profiler`` (CPU
    activity, and CUDA's on a CUDA device), its Chrome trace written to
    ``<save_dir>/profile/run.<pid>.pt.trace.json`` when the block ends."""
    if not config.profile:
        yield
        return
    trace_dir = os.path.join(config.save_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as profile:
        yield
    profile.export_chrome_trace(os.path.join(trace_dir, f"run.{os.getpid()}.pt.trace.json"))


def train(
    config: DistributedTrainingConfig, practitioners=None, device: str | None = None
) -> dict:
    """Run one task; returns ``{"performance": {round: row}}``."""
    if resolve_executor(config) == "sequential":
        ctx = build_task(config, practitioners, device)
        with _profiled(ctx.config, ctx.model_ctx.device):
            return run_task(ctx)
    session = build_session(config, practitioners, device)
    with _profiled(session.config, session.device):
        result = _remap_sv(session.run(), session.practitioners)
    get_logger().info("training done on %s (%d rounds)", session.device, len(result["performance"]))
    return result


def train_with_recovery(
    config: DistributedTrainingConfig,
    practitioners=None,
    max_restarts: int | None = None,
    backoff_seconds: float | None = None,
    sleep_fn=None,
    device: str | None = None,
) -> dict:
    """:func:`train` under a bounded-retry supervisor (the JAX package's):
    a crashed attempt (a simulated kill, a watchdog timeout, any
    ``Exception``; not Ctrl-C) is relaunched after an exponential backoff
    from the newest loadable checkpoint.

    * attempt ``k`` runs in ``<save_dir>_retry<k>`` and resumes from the
      newest attempt directory (or the caller's ``resume_dir``) whose
      ``resumable_round`` is above 0: a torn newest checkpoint falls back
      to the round before it;
    * ``max_restarts`` and the backoff default from ``fault_tolerance``
      (``max_restarts``, ``restart_backoff_seconds``); past the budget the
      last error propagates unchanged;
    * the result is the last attempt's, whose restored and fresh record
      rows cover every round once, with a ``recovery`` summary (restarts,
      attempt directories, the final ``save_dir``);
    * a method without round checkpoints (sign_SGD) restarts from round 1;
    * with ``telemetry`` on, every attempt appends to the first attempt's
      trace (a relative ``telemetry.path`` is resolved once, against the
      first ``save_dir``): its offsets continue across the kills, so every
      row of the final record cross-links a line of one file.  The JAX
      supervisor starts a trace in each attempt's directory.

    ``sleep_fn`` replaces ``time.sleep`` for the backoff (tests)."""
    config = copy.deepcopy(config)
    if not config.save_dir:
        config.load_config_and_process()
    telemetry = dict(config.telemetry or {})
    if telemetry.get("enabled") and not os.path.isabs(telemetry.get("path") or ""):
        telemetry["path"] = os.path.abspath(
            os.path.join(config.save_dir, "server", telemetry.get("path") or "trace.jsonl")
        )
        config.telemetry = telemetry
    fault_conf = dict(config.fault_tolerance or {})
    if max_restarts is None:
        max_restarts = int(fault_conf.get("max_restarts", 2))
    if backoff_seconds is None:
        backoff_seconds = float(fault_conf.get("restart_backoff_seconds", 1.0))
    sleep = sleep_fn if sleep_fn is not None else time.sleep
    base_dir = config.save_dir
    attempt_dirs = [base_dir]
    current = config
    restarts = 0
    while True:
        try:
            result = train(current, practitioners=practitioners, device=device)
        except Exception as exc:  # noqa: BLE001 -- the supervisor heals any crash
            restarts += 1
            if restarts > max_restarts:
                get_logger().error(
                    "train_with_recovery: giving up after %d restart(s); last error: %s", max_restarts, exc
                )
                raise
            delay = backoff_seconds * (2 ** (restarts - 1))
            get_logger().warning(
                "train_with_recovery: attempt %d crashed (%s: %s); relaunching in %.1fs (%d/%d restarts)",
                restarts, type(exc).__name__, exc, delay, restarts, max_restarts,
            )
            if delay > 0:
                sleep(delay)
            candidates = list(reversed(attempt_dirs))
            caller_resume = dict(config.algorithm_kwargs or {}).get("resume_dir")
            if caller_resume:
                candidates.append(caller_resume)
            resume_dir, resume_round = None, 0
            for candidate in candidates:
                resume_round = resumable_round(candidate)
                if resume_round > 0:
                    resume_dir = candidate
                    break
            current = dataclasses.replace(current, save_dir=f"{base_dir}_retry{restarts}")
            current.algorithm_kwargs = dict(current.algorithm_kwargs)
            if resume_dir is not None:
                get_logger().info(
                    "train_with_recovery: resuming attempt %d from %s (round %d)",
                    restarts + 1, resume_dir, resume_round,
                )
                current.algorithm_kwargs["resume_dir"] = resume_dir
            else:
                get_logger().warning(
                    "train_with_recovery: nothing resumable yet — attempt %d restarts from scratch", restarts + 1
                )
                current.algorithm_kwargs.pop("resume_dir", None)
            attempt_dirs.append(current.save_dir)
            continue
        result["recovery"] = {"restarts": restarts, "attempt_dirs": list(attempt_dirs), "save_dir": current.save_dir}
        return result
