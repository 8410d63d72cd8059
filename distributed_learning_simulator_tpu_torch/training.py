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
  endpoints: ``fed_avg``, ``fed_paq``, ``fed_obd`` (NNADQ), ``fed_obd_sq``,
  ``fed_dropout_avg``, ``single_model_afd`` and ``sign_SGD`` (the methods
  ``method/`` registers).  fed_avg, fed_paq, fed_dropout_avg,
  single_model_afd, and the FedOBD pair at ``second_phase_epoch: 1``, draw
  what their SPMD sessions draw.  A failure on any thread sets the task's
  abort event, every blocking loop unwinds, and ``train`` re-raises the
  first error after joining the threads.

It runs on CUDA unless ``device="cpu"`` is passed (or set in the config),
and raises where no GPU is visible.  What the port does not run yet raises
``NotImplementedError`` naming the ROADMAP item.  ``fault_tolerance`` and
``aggregation_mode: buffered`` run on the SPMD FedAvg session (fed_avg,
fed_paq); the other SPMD sessions take only the kill schedule and the
supervisor's knobs (``parallel/spmd.py``).  The threaded executor refuses
the Shapley values, graph FL, the fault plan, buffered aggregation,
resume and ``watchdog_seconds`` (ROADMAP.md Queue 1 item 5, part 2), and
``float64_parity`` and the population store (item 7).

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
#: the ROADMAP item of each algorithm_kwarg the threaded executor refuses
#: (any other: item 5, part 2)
_THREADED_KWARG_ITEMS = {"float64_parity": "item 7", "population_store": "item 7"}
_PART_2 = "ROADMAP.md Queue 1 item 5, part 2"


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
    if resolve_executor(config) == "spmd":
        if algorithm not in SPMD_SESSION_BUILDERS:
            raise NotImplementedError(
                f"method {algorithm!r} under the SPMD executor is not ported yet (ROADMAP.md);"
                f" the port's SPMD sessions run {sorted(SPMD_SESSION_BUILDERS)}"
            )
    elif not CentralizedAlgorithmFactory.has_algorithm(algorithm):
        raise NotImplementedError(
            f"method {algorithm!r} on the threaded executor is not ported yet ({_PART_2}: the Shapley"
            f" values and graph FL); it runs {sorted(CentralizedAlgorithmFactory.config)}"
        )
    else:
        unsupported = sorted(set(config.algorithm_kwargs) - THREADED_ALGORITHM_KWARGS)
        if unsupported:
            items = [f"{k}: {_THREADED_KWARG_ITEMS.get(k, 'item 5, part 2')}" for k in unsupported]
            raise NotImplementedError(
                f"algorithm_kwargs are not ported yet on the threaded executor (ROADMAP.md Queue 1, {items})"
            )
    layouts = [k for k in _LAYOUT_KWARGS if int(config.model_kwargs.get(k, 0) or 0) > 1]
    spmd = resolve_executor(config) == "spmd"
    # the SPMD sessions gate fault_tolerance per class (parallel/spmd.py);
    # the graph sessions take (and, as the JAX ones, ignore) the kill
    # schedule and the supervisor's knobs; the threaded executor none of it
    plan = FaultPlan.from_config(config)
    if spmd and algorithm in _GRAPH_METHODS:
        faults_refused = plan is not None and not plan.only_recovery
    else:
        faults_refused = plan is not None and not spmd
    refused = {
        "model_kwargs": (layouts, "ROADMAP.md Queue 1 item 8"),
        "fault_tolerance": (faults_refused, _PART_2),
        "watchdog_seconds": (bool(config.watchdog_seconds) and not spmd, _PART_2),
        "parallel_number": (bool(config.parallel_number), _PART_2),
    }
    named = [f"{k} ({item})" for k, (v, item) in refused.items() if v]
    if named:
        raise NotImplementedError(f"{named} are not ported yet")


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

    def run(executor) -> None:
        try:
            executor.start()
        except TaskAbortedError:
            get_logger().debug("%s aborted", executor.name)
        except BaseException as exc:  # noqa: BLE001 -- re-raised by _harvest
            get_logger().exception("%s failed", executor.name)
            ctx.errors.append(exc)
            ctx.abort_event.set()
            ctx.topology.server_wakeup.set()

    for executor in [ctx.server, *ctx.workers]:
        ctx.threads.append(threading.Thread(target=run, args=(executor,), name=executor.name, daemon=True))
    for thread in ctx.threads:
        thread.start()


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
    get_logger().info(
        "threaded training done on %s (%d records)", ctx.model_ctx.device, len(result["performance"])
    )
    return result


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
