"""FedAvg rounds on one device (the port's ``parallel/spmd.py``).

The JAX session compiles a whole round into one program over a
``("clients", ...)`` mesh.  Here the clients axis is a Python loop on one
GPU, in chunks of ``client_chunk`` clients, with the JAX round's data flow:

1. cast the f32 master to the compute dtype once per round (bf16 under
   ``use_amp``; the identity in f32);
2. train each client of a chunk from that copy, in place in its row of a
   preallocated ``[mb, D]`` buffer in the compute dtype (the momentum
   trace lives in the same dtype);
3. call kernel K1 once per chunk: ``w[chunk] @ rows`` accumulated in f32
   into a ``[D]`` vector;
4. divide by the total weight and keep the result as the f32 master.

The port aggregates through K1 in f32 and bf16 alike; the JAX package's f32
per-leaf epilogue computes the same function.  Each round then evaluates
the master on the test set and writes a row of ``server/round_record.json``
with the JAX session's keys.  Each client's dropout draws from its own
generator, seeded from ``(seed, round, worker)``.

fed_paq is this session with ``quantization_level``: each client's
trained leaves become ``g + qsgd(p - g)`` before K1, with draws from the
codec's random source (``ops/quantization.py::CodecRandom``, the
``random`` entry of ``endpoint_kwargs.worker``), and ``received_mb``
prices an upload at ``ceil(log2(level + 1)) + 1`` bits a value.

``round_horizon`` H > 1 runs the H rounds the JAX session fuses into one
dispatch one after another, each with its own host read and record: the
H = 1 run, bit for bit (deferring the metric reads to a horizon's end
bought no time on the card, PERF.md).  As in the JAX package, only this
class (fed_avg, fed_paq) and the FedOBD session take a horizon; a
subclass with its own round program raises ``ValueError``.

``client_chunk: auto`` resolves through the calibration cache
(``util/calibration.py``) once the slot count is known; a miss gives the
default chunk.

``fault_tolerance`` (``util/faults.py``) folds into the round's host weight
row as in the JAX session: a dropped client weighs 0, a corrupt one NaN,
the host sleeps once for the slowest straggler, and the quorum is checked
before the round.  The update guard (``update_guard``, ``max_update_norm``)
checks each trained client's delta on the device (finite, and within the
norm) and zeroes a rejected client's entry of the device weight vector
that K1 reads; the survivors' total divides the sum, a round that rejects
everyone keeps the old master, and the reject count reaches the host after
the round's evaluation, where the post-guard quorum is checked.

``aggregation_mode: buffered`` (``util/buffered.py``) replays the arrival
schedule in logical time: each training round's weights are discounted by
the staleness their update lands with, and each client's row is routed to
the bucket of the flush it lands at, by one K1 launch per (chunk, bucket)
over the chunk's rows with the bucket's masked weights.  Bucket 0 and the
head of a ``[depth, D]`` f32 pending ring form the flush; the other
buckets refill the ring, shifted once a round.  A flush of weight 0 keeps
the old master.  A depth-0 schedule runs the synchronous round, bit for
bit.  Only this class (fed_avg, fed_paq) takes buffered aggregation.

Every session folds the fault plan into its weight rows and enforces the
quorum, as its JAX twin does; the update guard is gated per class
(:meth:`SpmdFedAvgSession._class_update_guard_reason`): this class, FedOBD
and sign_SGD run it, the sparse and Shapley sessions raise the JAX
session's ``ValueError``.  ``client_faults_nonfatal`` belongs to the
threaded executor: the JAX sessions take it and ignore it, and the port
refuses it (ROADMAP.md R18).

Round checkpoints and resume follow the JAX session.  The round's new
master is queued to ``aggregated_model/round_N.npz`` (the JAX package's
keys and layouts, through :class:`~..util.checkpoint.AsyncCheckpointWriter`:
one device-to-host copy of the flat f32 master, written on the writer's
thread while the evaluation runs) every ``checkpoint_every`` rounds (0: the
horizon), and always in the final round.  ``round_record.json`` is flushed
atomically every ``record_flush_every`` rounds (0: the horizon) and at exit;
``server/best_global_model.npz`` is a file copy of the best checkpointed
round.  A horizon H > 1 runs round by round but checkpoints, flushes,
promotes and fires kills on the JAX session's horizon boundaries, so both
packages write the same files.  ``resume_dir`` restores the newest round
that has a loadable checkpoint and a record row (``util/resume.py``) and
starts at the next; the random streams are keyed by ``(seed, round,
slot)``, so nothing is replayed.  A buffered resume drains the buffer: the
pending ring restarts at zeros and the updates trained before the resume
leave the cohort counts and the flush quorum.  ``kill_after_rounds`` fires
once the killed round is durable (``util/faults.py``), and
``watchdog_seconds`` guards the round call and the evaluation
(``parallel/watchdog.py``).

Telemetry (``util/telemetry.py``, ``config.telemetry``) follows the JAX
session's recorder and round loop.  The recorder's counters back
``dispatch_count``, ``host_sync_count``, ``rounds_run`` and
``reset_dispatch_stats()`` whether it is on or off.  With it on, the run
appends to ``server/trace.jsonl``: per round the ``dispatch`` events of the
JAX session's programs (``fold_rngs``, ``round``, ``eval``: the work the
port does in their place), a ``dispatch_call`` span around the round call
under the JAX program's name (``round[dense]``, ``round[gather]``,
``round[buffered]``, ``round[buffered-gather]``; ``horizon[h=N]`` and
``horizon[buffered,h=N]`` at H > 1; none for the sparse sessions, whose
JAX programs are called outside the recorder), ``checkpoint``, an ``eval``
span, ``host_sync``, ``hbm``, the buffered ``staleness`` and
``buffer_flush`` events, ``fault`` and the ``round`` span, whose offset
each ``round_record.json`` row carries as ``trace_offset``; ``resume``
where a run resumes.  At H > 1 the port still runs round by round: each
round makes the H = 1 dispatches and host sync (the JAX session: one of
each a horizon), and a ``horizon`` span covers the chunk.  The recorder's
``close`` is the checkpoint writer's ``roundtrace`` finalizer.  With
telemetry off, nothing of this runs but the counters.

The sparse-upload sessions (``parallel/spmd_sparse.py``) reuse the client
loop through :meth:`SpmdFedAvgSession._upload` (a trained client's row),
``_row_width``, ``_upload_dtype`` and ``_finish`` (the new master).
"""

import math
import os
import time

import numpy as np
import torch

from ..config import DistributedTrainingConfig
from ..engine.batching import fixed_size_partition, make_epoch_batches, stage_batches
from ..engine.engine import ComputeEngine, maybe_slow_metrics, summarize_metrics
from ..ml_type import MachineLearningPhase as Phase
from ..models.convert import from_jax, jax_leaves
from ..models.dropout import dropout_generator
from ..models.registry import causal_lm_targets
from ..ops.pytree import flat_stack_weighted_sum
from ..ops.quantization import CodecRandom, qsgd_quantize_dequantize
from ..util.buffered import BufferedSettings, compute_arrival_schedule, selection_uploaders, staleness_discount
from ..util.calibration import resolve_client_chunk
from ..util.checkpoint import AsyncCheckpointWriter, atomic_json_dump, jax_views
from ..util.faults import FaultPlan, QuorumLostError, apply_fault_plan
from ..util.resume import load_resume_state
from ..util.telemetry import TraceRecorder
from ..utils.logging import get_logger
from ..utils.selection import select_workers
from .watchdog import DeadlineWatchdog

#: algorithm_kwargs this session reads; any other key raises
SUPPORTED_ALGORITHM_KWARGS = frozenset(
    {
        "aggregation_mode",
        "buffer_size",
        "calibration_path",
        "client_chunk",
        "global_model_path",
        "min_client_quorum",
        "random_client_number",
        "record_flush_every",
        "resume_dir",
        "round_horizon",
        "staleness_alpha",
    }
)


def _client_phase_indices(config, practitioners, phase):
    """Worker-ordered per-client index arrays for one dataset phase."""
    indices = []
    for practitioner in sorted(practitioners, key=lambda p: p.worker_id):
        sampled = practitioner.get_sampler(config.dataset_name).sample(
            practitioner.practitioner_id
        )
        indices.append(np.asarray(sampled.get(phase, []), np.int64))
    return indices


def _stack_slot_batches(dataset, per_client_indices, n_slots, batch_size):
    """Pad every client's index set to ``n_batches × batch_size`` (mask 0 on
    padding), add zero-weight padding slots up to ``n_slots``, and reshape
    to ``[C, n_batches, B, ...]``.  Returns (data, n_batches)."""
    max_size = max((len(i) for i in per_client_indices), default=0)
    n_batches = max(1, (max_size + batch_size - 1) // batch_size)
    slot_size = n_batches * batch_size
    inputs, targets, masks = [], [], []
    for idx in per_client_indices:
        padded, mask = fixed_size_partition(idx, slot_size)
        inputs.append(dataset.inputs[padded])
        targets.append(dataset.targets[padded])
        masks.append(mask)
    while len(inputs) < n_slots:
        inputs.append(np.zeros_like(inputs[0]))
        targets.append(np.zeros_like(targets[0]))
        masks.append(np.zeros_like(masks[0]))

    def stack(parts, extra_shape):
        return np.stack(parts).reshape(n_slots, n_batches, batch_size, *extra_shape)

    data = {
        "input": stack(inputs, dataset.inputs.shape[1:]),
        "target": stack(targets, ()),
        "mask": stack(masks, ()),
    }
    return data, n_batches


def stack_client_data(config, dataset_collection, practitioners, n_slots):
    """Per-client training data ``[C, n_batches, B, ...]`` (host numpy);
    returns (data, dataset_sizes, n_batches)."""
    train = dataset_collection.get_dataset(Phase.Training)
    per_client_indices = _client_phase_indices(config, practitioners, Phase.Training)
    sizes = [len(idx) for idx in per_client_indices]
    data, n_batches = _stack_slot_batches(train, per_client_indices, n_slots, config.batch_size)
    dataset_sizes = np.asarray(sizes + [0] * (n_slots - len(sizes)), np.float32)
    return data, dataset_sizes, n_batches


def stack_client_val_data(config, dataset_collection, practitioners, n_slots):
    """Per-client VALIDATION batches ``[C, n_batches, B, ...]``, or None when
    the phase is absent or empty: the substrate of the iid best-epoch upload
    policy.  Clients with an empty split get all-masked batches, tie at
    accuracy 0 every epoch, and so upload their final epoch."""
    if not dataset_collection.has_dataset(Phase.Validation):
        return None
    val = dataset_collection.get_dataset(Phase.Validation)
    if int(np.asarray(val.inputs).shape[0]) == 0:
        return None
    per_client_indices = _client_phase_indices(config, practitioners, Phase.Validation)
    if max((len(i) for i in per_client_indices), default=0) == 0:
        return None
    data, _ = _stack_slot_batches(val, per_client_indices, n_slots, config.batch_size)
    return data


def loss_counts(model_ctx, host: dict) -> list:
    """``[C][n_batches]`` host counts of what each batch's loss averages
    over: samples, or tokens under ``causal_lm`` (the engine's no-op
    test, as the JAX engine tests its loss count)."""
    if model_ctx.loss_type == "causal_lm":
        shape = host["input"].shape
        tokens = torch.from_numpy(host["input"].reshape(-1, shape[-1]))
        mask = torch.from_numpy(host["mask"].reshape(-1))
        _, token_mask = causal_lm_targets(tokens, mask, model_ctx.pad_id)
        return token_mask.sum(dim=-1).reshape(shape[:-1]).sum(dim=-1).tolist()
    return host["mask"].sum(axis=-1).tolist()


def scan_local_epochs(
    engine: ComputeEngine,
    epochs: int,
    params: torch.Tensor,
    data,
    counts,
    val_data=None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """One client's local training, in place on the flat ``params`` (which
    start as the round's global copy): ``epochs`` of SGD with a fresh
    optimizer state; dropout draws from ``generator``.  With ``val_data`` (the iid best-epoch policy) the
    params left behind are the epoch with the best validation accuracy,
    ``>=`` so a later epoch wins ties; the choice stays on the device.
    Returns the summed training metrics."""
    _, summed = scan_local_epochs_carry(engine, epochs, params, data, counts, None, val_data, generator)
    return summed


def scan_local_epochs_carry(
    engine: ComputeEngine,
    epochs: int,
    params: torch.Tensor,
    data,
    counts,
    opt_state=None,
    val_data=None,
    generator: torch.Generator | None = None,
):
    """:func:`scan_local_epochs` from a given optimizer state (fresh when
    None: FedOBD phase 2 continues each client's state), which it
    updates in place; returns ``(opt_state, summed metrics)``.  The
    best-epoch policy cannot take a carried state: the state left behind
    is the last epoch's, not the best one's."""
    assert opt_state is None or val_data is None, "opt_state continuation with the best-epoch policy"
    if opt_state is None:
        opt_state = engine.init_opt_state(params)
    summed = None
    best = best_acc = None
    if val_data is not None:
        best = params.clone()
        best_acc = torch.full((), -1.0, device=params.device)
    for _ in range(epochs):
        metrics = engine.train_epoch(params, opt_state, data, counts, generator)
        summed = metrics if summed is None else {k: summed[k] + metrics[k] for k in summed}
        if val_data is not None:
            val = engine.evaluate(engine.layout.split(params), val_data)
            acc = val["correct"] / torch.clamp(val["count"], min=1.0)
            better = acc >= best_acc
            best = torch.where(better, params, best)
            best_acc = torch.where(better, acc, best_acc)
    if best is not None:
        params.copy_(best)
    return opt_state, summed


class SpmdFedAvgSession:
    """FedAvg rounds with the clients as a chunked loop on one device
    (fed_paq with ``quantization_level``)."""

    #: algorithm_kwargs this session reads; any other key raises
    supported_algorithm_kwargs = SUPPORTED_ALGORITHM_KWARGS
    #: stage the per-client validation data of the iid best-epoch policy
    _uses_val_policy = True

    def __init__(
        self,
        config: DistributedTrainingConfig,
        dataset_collection,
        model_ctx,
        engine: ComputeEngine,
        practitioners,
        quantization_level: int | None = None,
    ) -> None:
        unsupported = sorted(set(config.algorithm_kwargs) - self.supported_algorithm_kwargs)
        if unsupported:
            raise NotImplementedError(
                f"algorithm_kwargs {unsupported} are not ported yet (ROADMAP.md, port: round machinery)"
            )
        #: the rounds the JAX session fuses into one dispatch (run one by one here)
        self.round_horizon = max(1, int(config.algorithm_kwargs.get("round_horizon", 1) or 1))
        reason = self._horizon_unsupported_reason()
        if self.round_horizon > 1 and reason:
            raise ValueError(reason)
        self.config = config
        self.practitioners = practitioners
        self.quantization_level = quantization_level
        self._random = config.endpoint_kwargs.get("worker", {}).get("random") or CodecRandom()
        #: the leaves in the JAX package's key order: the codecs' order
        self._jax_leaves = jax_leaves(engine.layout.keys, engine.layout.shapes)
        self.model_ctx = model_ctx
        self.engine = engine
        self.device = model_ctx.device
        self.n_slots = config.worker_number
        #: the slots a round walks (the calibration key's ``s_pad``)
        self.s_pad = self.n_slots
        raw_chunk = config.algorithm_kwargs.get("client_chunk", 0)
        if isinstance(raw_chunk, str) and raw_chunk.strip().lower() == "auto":
            # a hit is the calibrated chunk; a miss is 0, the default
            raw_chunk = resolve_client_chunk(self, path=config.algorithm_kwargs.get("calibration_path"))
        self.client_chunk = int(raw_chunk or 0)
        self._stat: dict[int, dict] = {}
        self._init_faults(config)
        self._init_checkpoints(config)

        host, self._dataset_sizes, _ = stack_client_data(
            config, dataset_collection, practitioners, self.n_slots
        )
        self._counts = loss_counts(model_ctx, host)  # [C][n_batches], on the host
        self._data = self._to_device(host)
        self._val_data = None
        if self._uses_val_policy and config.dataset_sampling == "iid" and config.epoch > 1:
            val = stack_client_val_data(config, dataset_collection, practitioners, self.n_slots)
            if val is not None:
                self._val_data = self._to_device(val)
        test = dataset_collection.get_dataset(Phase.Test)
        self._eval_batches = self._to_device(make_epoch_batches(test, config.batch_size))

    def _init_faults(self, config) -> None:
        """The fault plan, the update guard and the buffered schedule, each
        gated per class as in the JAX session."""
        self._fault_plan = FaultPlan.from_config(config)
        self._min_quorum = int(config.algorithm_kwargs.get("min_client_quorum", 0) or 0)
        self._update_guard = bool(self._fault_plan is not None and self._fault_plan.update_guard)
        self._max_update_norm = self._fault_plan.max_update_norm if self._fault_plan else 0.0
        reason = self._class_update_guard_reason()
        if self._update_guard and reason:
            raise ValueError(
                f"fault_tolerance.update_guard is unsupported here: {reason} — drop the knob for this session"
            )
        plan = self._fault_plan
        if plan is not None and plan.client_faults_nonfatal:
            raise NotImplementedError(
                "fault_tolerance.client_faults_nonfatal demotes the threaded executor's crashed workers; an SPMD"
                " session has none, and the JAX session ignores the knob (ROADMAP.md R18)"
            )
        self._buffered = BufferedSettings.from_config(config)
        self._arrival_schedule = None
        self._buffered_depth = 0
        if self._buffered is not None:
            reason = self._class_buffered_reason()
            if reason:
                raise ValueError(
                    f"algorithm_kwargs.aggregation_mode=buffered is unsupported here: {reason} — drop the"
                    " knob for this session"
                )
            self._arrival_schedule = compute_arrival_schedule(
                self._buffered, plan, config.worker_number, config.round, selection_uploaders(config)
            )
            self._buffered_depth = self._arrival_schedule.max_staleness
        #: a depth-0 schedule runs the synchronous round, bit for bit
        self._buffered_active = self._buffered_depth > 0
        #: the buffered pending ring: ([depth, D] f32 sums, [depth] weights)
        self._pending = None
        #: the guard's reject count of the last round (a device scalar)
        self._rejected = None
        #: origins below this trained before a resume: their pending
        #: contributions died with the killed process
        self._buffered_origin_floor = 1
        #: the earliest scheduled kill reached but not fired yet
        self._kill_armed_round: int | None = None

    def _init_checkpoints(self, config) -> None:
        """The checkpoint and record cadences, the writer and the watchdog,
        as the JAX session sets them up."""
        self._checkpoint_every = max(1, int(config.checkpoint_every or 0) or self.round_horizon)
        self._record_flush_every = max(
            1, int(config.algorithm_kwargs.get("record_flush_every", 0) or 0) or self.round_horizon
        )
        self._last_ckpt_round = 0
        self._ckpt_queued_round: int | None = None
        self._record_path: str | None = None
        self._record_dirty = False
        self._max_acc = 0.0
        #: the accuracy high-water mark over checkpointed rounds (the promotable ones)
        self._best_ckpt_acc = 0.0
        self._ckpt = AsyncCheckpointWriter()
        self._ckpt.register_finalizer("round_record", self._flush_record)
        self._watchdog = DeadlineWatchdog.from_config(config, self.device)
        # roundtrace: the counters always; records only with telemetry.enabled
        self._trace = TraceRecorder.from_config(config, device=self.device)
        # the trace's tail lands through the writer's exit hook, errors included
        self._ckpt.register_finalizer("roundtrace", self._trace.close)

    # ------------------------------------------------------------ telemetry
    @property
    def dispatch_count(self) -> int:
        return self._trace.counters.get("dispatch", 0)

    @property
    def host_sync_count(self) -> int:
        return self._trace.counters.get("host_sync", 0)

    @property
    def rounds_run(self) -> int:
        return self._trace.counters.get("rounds", 0)

    def reset_dispatch_stats(self) -> None:
        self._trace.reset_counters("dispatch", "host_sync", "rounds")

    def _jax_gathers(self) -> bool:
        """Whether the JAX session trains the selected slots only (its
        selection gather: ``random_client_number`` below ``worker_number``)."""
        k = self.config.algorithm_kwargs.get("random_client_number")
        return k is not None and int(k) < self.config.worker_number

    def _round_program(self, horizon: int) -> str | None:
        """The JAX session's name of the program a round call runs (a chunk
        of ``horizon`` rounds); None where the JAX class calls its program
        outside the recorder (the sparse sessions)."""
        if type(self) is not SpmdFedAvgSession:
            return None
        if self.round_horizon > 1:
            return f"horizon[buffered,h={horizon}]" if self._buffered_active else f"horizon[h={horizon}]"
        gather = self._jax_gathers()
        if self._buffered_active:
            return "round[buffered-gather]" if gather else "round[buffered]"
        return "round[gather]" if gather else "round[dense]"

    def _dispatch_round(self, global_vec, weights, round_number, delays, horizon: int):
        """:meth:`run_round` through the recorder's dispatch tail, priced
        over the master, the weight row and the client data, as the JAX
        program's arguments."""
        program = self._round_program(horizon)
        args = (global_vec, weights, round_number, delays)
        if program is None:
            return self.run_round(*args)
        cost_args = (global_vec, weights, self._data, self._val_data or {})
        return self._trace.dispatch(program, self.run_round, args, cost_args=cost_args)

    def _trace_fault_event(self, round_number: int, rejected, selected=None) -> None:
        """One ``fault`` event a round under the fault machinery: the
        guard's reject count and how many SELECTED clients the plan dropped
        (host state the loop already owns).  ``selected`` overrides the
        round's cohort."""
        plan = self._fault_plan
        if not self._trace.enabled or plan is None:
            return
        if not (plan.injection_active or self._update_guard):
            return
        dropped = 0
        if plan.injection_active:
            if selected is None:
                selected = select_workers(
                    self.config.seed,
                    round_number,
                    self.config.worker_number,
                    self.config.algorithm_kwargs.get("random_client_number"),
                )
            dropped = len(plan.dropped_clients(round_number, self.config.worker_number) & set(selected))
        self._trace.event("fault", round=round_number, rejected_updates=int(rejected), dropped_clients=dropped)

    @classmethod
    def _class_update_guard_reason(cls) -> str | None:
        """Why the JAX session refuses ``update_guard`` for this class (None:
        it runs it): the sessions with a round program of their own."""
        if cls is not SpmdFedAvgSession:
            return f"{cls.__name__} builds its own round program"
        return None

    @classmethod
    def _class_buffered_reason(cls) -> str | None:
        """Why ``aggregation_mode: buffered`` is refused for this class, in
        the JAX session's words (None: taken)."""
        if cls is not SpmdFedAvgSession:
            return (
                "buffered aggregation (aggregation_mode: buffered) is"
                " implemented on the client-axis FedAvg family;"
                f" {cls.__name__} still runs round-barriered"
            )
        return None

    @classmethod
    def _horizon_unsupported_reason(cls) -> str | None:
        """Why ``round_horizon > 1`` is refused for this class (None: it is
        taken), in the JAX session's words: only the FedAvg round program
        and the sessions that extend it to their own (FedOBD) fuse."""
        if cls is not SpmdFedAvgSession:
            return (
                "round_horizon > 1 requires a fusable round program;"
                f" {cls.__name__} builds its own round function —"
                " run it with round_horizon=1"
            )
        return None

    def _to_device(self, batches: dict) -> dict[str, torch.Tensor]:
        """Host batches on the device (``engine/batching.py::stage_batches``)."""
        return stage_batches(batches, self.model_ctx.compute_dtype, self.device)

    def chunk_size(self) -> int:
        """Clients per aggregation chunk: ``client_chunk`` (8 when unset,
        the JAX session's accelerator default), lowered to a divisor of
        the slot count."""
        mb = self.client_chunk if self.client_chunk > 0 else 8
        mb = max(1, min(mb, self.n_slots))
        while self.n_slots % mb:
            mb -= 1
        return mb

    def _base_weight_row(self, round_number: int) -> np.ndarray:
        """``[n_slots]`` aggregation weights: dataset sizes of the round's
        selected workers, 0 elsewhere."""
        selected = select_workers(
            self.config.seed,
            round_number,
            self.config.worker_number,
            self.config.algorithm_kwargs.get("random_client_number"),
        )
        weights = np.zeros(self.n_slots, np.float32)
        for worker_id in selected:
            weights[worker_id] = self._dataset_sizes[worker_id]
        return weights

    def _select_weights(self, round_number: int) -> np.ndarray:
        """The round's weight row with the fault plan folded in (dropped:
        0, corrupt: NaN) and the quorum enforced; without a plan, the base
        row, bit for bit."""
        return apply_fault_plan(
            self._fault_plan,
            self._min_quorum,
            round_number,
            None,
            self._base_weight_row(round_number),
            self.config.worker_number,
        )

    def _buffered_select_weights(self, round_number: int) -> tuple[np.ndarray, np.ndarray]:
        """The buffered replay's ``(weights, delays)`` of one training round:
        the flush quorum checked, a landing update's weight discounted by
        its staleness, a never-landing one 0, a corrupt one NaN; no
        straggler sleep (the replay runs in logical time)."""
        self._buffered_flush_quorum(round_number)
        weights = self._base_weight_row(round_number)
        schedule, plan = self._arrival_schedule, self._fault_plan
        delays = np.zeros(len(weights), np.int32)
        corrupt = (
            plan.corrupt_clients(round_number, self.config.worker_number)
            if plan is not None and plan.injection_active
            else frozenset()
        )
        for wid in range(len(weights)):
            if not weights[wid]:
                continue  # unselected
            delay = schedule.delay(wid, round_number)
            if delay is None:
                weights[wid] = 0.0  # lost, or lands past the run's end
                continue
            delays[wid] = delay
            if wid in corrupt:
                weights[wid] = np.nan
            else:
                weights[wid] = np.float32(
                    float(weights[wid]) * staleness_discount(delay, self._buffered.staleness_alpha)
                )
        return weights, delays

    def _buffered_flush_quorum(self, round_number: int) -> None:
        """An explicit ``min_client_quorum`` against the flush's arrivals that
        are not corrupt (no implicit floor: an empty flush keeps the old
        master)."""
        if self._min_quorum <= 0:
            return
        plan = self._fault_plan
        survivors = sum(
            1
            for item in self._arrival_schedule.live_cohort(round_number, self._buffered_origin_floor)
            if plan is None or item.worker not in plan.corrupt_clients(item.origin, self.config.worker_number)
        )
        if survivors < self._min_quorum:
            message = (
                f"flush {round_number}: {survivors} surviving buffered"
                f" arrivals below min_client_quorum={self._min_quorum} —"
                " aborting the round loudly"
            )
            get_logger().error(message)
            raise QuorumLostError(message)

    def _buffered_round_extras(self, round_number: int) -> dict:
        """The flush's record columns, from the host schedule; with
        telemetry, a ``staleness`` event for each late-merged update and a
        ``buffer_flush`` event (the replay's flush is the round)."""
        schedule, floor = self._arrival_schedule, self._buffered_origin_floor
        cohort = schedule.live_cohort(round_number, floor)
        extras = {
            "flush_cohort": len(cohort),
            "stale_updates": schedule.stale_count(round_number, floor),
            "buffer_depth": schedule.buffer_depth_after(round_number, floor),
        }
        if self._trace.enabled:
            for item in cohort:
                if item.staleness:
                    self._trace.event(
                        "staleness",
                        round=round_number,
                        worker=item.worker,
                        origin=item.origin,
                        staleness=item.staleness,
                        discount=round(item.discount, 6),
                    )
            self._trace.event(
                "buffer_flush",
                round=round_number,
                cohort=extras["flush_cohort"],
                stale_updates=extras["stale_updates"],
                buffer_depth=extras["buffer_depth"],
            )
        return extras

    def _post_guard_quorum(self, round_number: int, participating: int, rejected: int) -> None:
        """Survivors after the guard (uploads that reached aggregation, NaN
        weights included, less the rejected) against the quorum, floor 1;
        the round's record is already written.  Not under the buffered
        replay, whose flush quorum is checked before the round."""
        if not self._update_guard or self._buffered_active:
            return
        survivors = participating - rejected
        quorum = max(self._min_quorum, 1)
        if survivors < quorum:
            message = (
                f"round {round_number}: {survivors} surviving uploads after "
                f"update-guard rejections ({rejected} rejected of "
                f"{participating}) below min_client_quorum={quorum} — "
                "aborting loudly (the round kept the previous params)"
            )
            get_logger().error(message)
            raise QuorumLostError(message)

    def _start(self) -> tuple[torch.Tensor, int]:
        """The f32 master and the first round to run: the newest resumable
        round of ``resume_dir`` (its record rows restored), else
        :meth:`_init_global_params` and round 1."""
        resume_dir = self.config.algorithm_kwargs.get("resume_dir")
        if resume_dir:
            params, stats, last = load_resume_state(resume_dir)
            if params is not None:
                self._stat.update(stats)
                self._max_acc = max(s["test_accuracy"] for s in self._stat.values())
                # the restored best_global_model.npz is at most this good
                self._best_ckpt_acc = self._max_acc
                self._buffered_origin_floor = last + 1  # a resume drains the buffer
                get_logger().info("resumed from %s round %d", resume_dir, last)
                self._trace.event("resume", round=last + 1, source=str(resume_dir))
                return self._master_from_jax(params), last + 1
            get_logger().warning("nothing resumable under %s; starting fresh", resume_dir)
        return self._init_global_params(), 1

    def _init_global_params(self) -> torch.Tensor:
        """The f32 master as one flat vector: ``global_model_path`` (an npz
        of JAX parameters, through the weight bridge) or a fresh init."""
        init_path = self.config.algorithm_kwargs.get("global_model_path")
        if init_path:
            with np.load(init_path) as blob:
                return self._master_from_jax({k: blob[k] for k in blob.files})
        params = self.engine.init_params(self.config.seed)
        return self.engine.layout.flatten({k: v.to(self.device, torch.float32) for k, v in params.items()})

    def _master_from_jax(self, params: dict) -> torch.Tensor:
        """JAX-keyed numpy parameters as the flat f32 master (exact: the
        bridge only transposes)."""
        params = {k: v.to(self.device, torch.float32) for k, v in from_jax(params).items()}
        return self.engine.layout.flatten(params)

    #: the rows' dtype (None: the compute dtype, as the client trained)
    _upload_dtype: torch.dtype | None = None

    def _row_width(self, size: int) -> int:
        """Values in a client's row of the K1 input for ``size`` parameters."""
        return size

    def run_round(
        self,
        global_vec: torch.Tensor,
        weights: np.ndarray,
        round_number: int = 1,
        delays: np.ndarray | None = None,
    ) -> torch.Tensor:
        """One round: the new f32 master from ``global_vec``.  With
        ``delays`` (the buffered replay) each slot's row goes to the bucket
        of the flush it lands at, ``delays[slot]`` flushes from now."""
        engine = self.engine
        self._round_weight_row = weights  # the host row the uploads see (SMAFD's residuals)
        start = global_vec.to(self.model_ctx.compute_dtype)  # once per round
        work = torch.empty_like(start)
        mb = self.chunk_size()
        width = self._row_width(global_vec.numel())
        # rows start on 128-byte boundaries, so K1 reads 16-byte vectors
        row_stride = -(-width // 64) * 64
        rows = torch.empty(mb, row_stride, dtype=self._upload_dtype or start.dtype, device=self.device)
        rows = rows[:, :width]
        buckets = 1 if delays is None else self._buffered_depth + 1
        acc = torch.zeros(buckets, width, device=self.device)
        # one host->device copy a round (a copy on the CPU too: the guard writes to it)
        w = torch.from_numpy(weights).to(self.device, copy=True)
        if delays is not None:
            routes = torch.from_numpy(delays).to(self.device)
            bucket_weights = torch.zeros(buckets, device=self.device)
        if self._update_guard:
            self._rejected = torch.zeros((), device=self.device)
        for c0 in range(0, self.n_slots, mb):
            for j in range(mb):
                slot = c0 + j
                if weights[slot] == 0:  # unselected: contributes exactly 0
                    rows[j].zero_()
                    continue
                work.copy_(start)
                val = None
                if self._val_data is not None:
                    val = {k: v[slot] for k, v in self._val_data.items()}
                scan_local_epochs(
                    engine,
                    self.config.epoch,
                    work,
                    {k: v[slot] for k, v in self._data.items()},
                    self._counts[slot],
                    val,
                    dropout_generator(self.config.seed, round_number, slot, self.device),
                )
                with torch.no_grad():
                    self._upload(rows[j], work, start, global_vec, round_number - 1, slot)
                    if self._update_guard:
                        self._guard(rows[j], start, w, slot)
            if delays is None:
                acc[0] += flat_stack_weighted_sum(rows, w[c0 : c0 + mb])
                continue
            for k in range(buckets):  # one K1 a bucket, over the chunk's rows
                wk = torch.where(routes[c0 : c0 + mb] == k, w[c0 : c0 + mb], 0.0)
                acc[k] += flat_stack_weighted_sum(rows, wk)
                bucket_weights[k] += wk.sum()
        if delays is not None:
            return self._flush(acc, bucket_weights, global_vec)
        if self._update_guard:
            # the survivors' total; a round that rejects everyone keeps the old master
            total = w.sum()
            return torch.where(total > 0, acc[0] / torch.clamp(total, min=1e-12), global_vec)
        return self._finish(acc[0], weights)

    def _guard(self, row: torch.Tensor, start: torch.Tensor, w: torch.Tensor, slot: int) -> None:
        """The update guard on one trained row, on the device: a delta
        against the round's start that is not finite or (``max_update_norm``)
        too long, or a poisoned (NaN) weight, zeroes the slot's weight in
        ``w``; a participating slot rejected adds 1 to the round's count."""
        delta = row.float() - start.float()
        ok = torch.isfinite(delta).all() & torch.isfinite(w[slot])
        if self._max_update_norm > 0:
            limit = torch.tensor(self._max_update_norm, dtype=torch.float32, device=delta.device) ** 2
            ok &= delta.square().sum() <= limit
        self._rejected += torch.where(ok, 0.0, (w[slot] != 0).float())  # NaN != 0
        w[slot] = torch.where(ok, w[slot], 0.0)

    def _flush(self, bucket_sums: torch.Tensor, bucket_weights: torch.Tensor, global_vec: torch.Tensor):
        """The buffered flush: bucket 0 plus the pending ring's head, over
        their weight (a flush of weight 0 keeps the old master; a NaN weight
        poisons it visibly); buckets 1..depth refill the shifted ring."""
        sums, totals = self._pending
        flush_weight = bucket_weights[0] + totals[0]
        flush_sum = bucket_sums[0] + sums[0]
        new = torch.where(flush_weight == 0, global_vec, flush_sum / torch.clamp(flush_weight, min=1e-12))
        self._pending = (
            bucket_sums[1:] + torch.cat([sums[1:], torch.zeros_like(sums[:1])]),
            bucket_weights[1:] + torch.cat([totals[1:], torch.zeros_like(totals[:1])]),
        )
        return new

    def _upload(self, row, trained, start, g, aggregate: int, slot: int) -> None:
        """A trained client's row: its parameters ``trained`` (fed_paq:
        through :meth:`_paq_upload` against the round's start, the
        compute-dtype ``start``; ``g`` is the f32 master)."""
        row.copy_(trained)
        if self.quantization_level is not None:
            self._paq_upload(row, start, aggregate, slot)

    def _finish(self, acc: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
        """The new master from the weighted sum of the rows."""
        return acc / max(float(weights.sum()), 1e-12)

    def _paq_upload(self, row: torch.Tensor, start: torch.Tensor, aggregate: int, slot: int) -> None:
        """fed_paq's upload, in place on a trained row: each leaf ``p``
        becomes ``g + qsgd(p - g)`` against the round's start ``g``, in the
        compute dtype, the leaf's draws in the JAX layout's order."""
        count = len(self._jax_leaves)
        for i, leaf in enumerate(self._jax_leaves):
            p, g = row[leaf.start : leaf.stop], start[leaf.start : leaf.stop]
            delta = leaf.to_jax(p - g)
            uniform = self._random.session_uniform(
                self.config.seed, aggregate, slot, i, count, delta.shape, self.device
            )
            p.copy_(g + leaf.from_jax(qsgd_quantize_dequantize(delta, uniform, self.quantization_level)))

    def _upload_cost_factor(self) -> float:
        """What an upload costs against f32 values: fed_paq's QSGD sends
        ``ceil(log2(level + 1))`` level bits and a sign bit a value."""
        if self.quantization_level is None:
            return 1.0
        return (math.ceil(math.log2(self.quantization_level + 1)) + 1) / 32

    def _evaluate(self, global_vec: torch.Tensor) -> dict:
        params = self.engine.layout.split(global_vec)
        metric = summarize_metrics(self.engine.evaluate(params, self._eval_batches))
        metric.update(maybe_slow_metrics(self.config, self.engine, params, self._eval_batches))
        return metric

    def run(self) -> dict:
        config = self.config
        global_vec, start_round = self._start()
        self._last_ckpt_round = start_round - 1
        save_dir = os.path.join(config.save_dir, "server")
        os.makedirs(save_dir, exist_ok=True)
        param_mb = global_vec.numel() * 4 / 1e6
        if self._buffered_active:
            depth = self._buffered_depth
            self._pending = (
                torch.zeros(depth, global_vec.numel(), device=self.device),
                torch.zeros(depth, device=self.device),
            )
        trace = self._trace
        with self._ckpt:  # flushes the record and drains the writes at exit, errors included
            for round_number in range(start_round, config.round + 1):
                start = time.monotonic()
                # the JAX session's horizon chunk: [first, boundary]
                first = round_number - (round_number - start_round) % self.round_horizon
                boundary = min(first + self.round_horizon - 1, config.round)
                if round_number == first:
                    chunk_start = start
                    trace.maybe_profile_start(first, boundary)
                delays = None
                if self._buffered_active:
                    weights, delays = self._buffered_select_weights(round_number)
                else:
                    weights = self._select_weights(round_number)
                trace.event("dispatch", program="fold_rngs", round=round_number)
                global_vec = self._watchdog.call(
                    lambda g=global_vec, w=weights, r=round_number, d=delays, h=boundary - first + 1: (
                        self._dispatch_round(g, w, r, d, h)
                    ),
                    phase="round",
                    round_number=round_number,
                )
                trace.event("dispatch", program="round", round=round_number)
                # queued now, so the copy and the write overlap the evaluation
                if round_number == boundary and self._should_checkpoint(round_number):
                    self._save_checkpoint(round_number, global_vec)
                    trace.event("checkpoint", round=round_number)
                # reads the metrics: the round's one sync
                with trace.span("eval", round=round_number):
                    metric = self._watchdog.call(
                        lambda g=global_vec: self._evaluate(g), phase="eval", round_number=round_number
                    )
                trace.event("dispatch", program="eval", round=round_number)
                trace.event("host_sync", round=round_number)
                trace.hbm_watermark(round_number)
                trace.count("rounds")
                selected = int((weights > 0).sum())
                extra = {
                    "received_mb": selected * param_mb * self._upload_cost_factor(),
                    "sent_mb": selected * param_mb,
                    "round_seconds": time.monotonic() - start,
                }
                rejected = 0
                if self._update_guard:
                    rejected = int(self._rejected)  # ready: the evaluation has synced
                    extra["rejected_updates"] = rejected
                if self._buffered_active:
                    extra.update(self._buffered_round_extras(round_number))
                self._trace_fault_event(round_number, rejected)
                # mid-horizon rounds have no checkpoint, as in the JAX session's fused loop
                self._record(round_number, metric, global_vec if round_number == boundary else None, save_dir, extra)
                self._post_guard_quorum(round_number, int((weights != 0).sum()), rejected)
                if round_number == boundary:
                    if self.round_horizon > 1:
                        trace.span_record(
                            "horizon",
                            time.monotonic() - chunk_start,
                            first_round=first,
                            last_round=boundary,
                            rounds=boundary - first + 1,
                        )
                    self._maybe_kill(first, boundary)
                    trace.maybe_profile_stop(boundary)
        return {"performance": self._stat}

    def _should_checkpoint(self, round_number: int) -> bool:
        """Every ``checkpoint_every`` rounds since the last checkpoint, and
        always the run's final round (so the exit state resumes)."""
        if round_number >= self.config.round:
            return True
        return round_number - self._last_ckpt_round >= self._checkpoint_every

    def _save_checkpoint(self, round_number: int, global_vec: torch.Tensor) -> None:
        """Queue ``aggregated_model/round_N.npz``: the f32 master in the JAX
        keys and layouts, one device-to-host copy."""
        model_dir = os.path.join(self.config.save_dir, "aggregated_model")
        os.makedirs(model_dir, exist_ok=True)
        path = os.path.join(model_dir, f"round_{round_number}.npz")
        self._ckpt.save_rows(path, [global_vec], lambda host: jax_views(host[0], self._jax_leaves))
        self._ckpt_queued_round = round_number
        self._last_ckpt_round = round_number

    def _record(self, round_number, metric, global_vec, save_dir, extra) -> None:
        """The round's row, then (sessions that queue no checkpoint of their
        own) the round's checkpoint on its cadence, then the promotion of a
        better checkpointed round to ``best_global_model.npz`` by a file
        copy chained behind its save."""
        self._note_round(round_number, metric, save_dir, extra)
        if self._ckpt_queued_round != round_number and global_vec is not None and self._should_checkpoint(round_number):
            self._save_checkpoint(round_number, global_vec)
        self._max_acc = max(self._max_acc, metric["accuracy"])
        if self._ckpt_queued_round == round_number and metric["accuracy"] > self._best_ckpt_acc:
            self._best_ckpt_acc = metric["accuracy"]
            self._ckpt.copy_last_to(os.path.join(save_dir, "best_global_model.npz"))

    def _maybe_kill(self, first_round: int, last_round: int | None = None) -> None:
        """Arm a kill scheduled in the rounds ``first_round..last_round`` and
        fire the earliest armed one once its round is durable: a checkpoint
        at or past it queued and the record rows flushed.  The raise leaves
        through the writer's ``with`` block, which drains the writes."""
        plan = self._fault_plan
        if plan is None:
            return
        last = first_round if last_round is None else last_round
        self._kill_armed_round = plan.arm_kill(first_round, last, self._kill_armed_round)
        plan.fire_armed_kill(self._kill_armed_round, self._last_ckpt_round, record_durable=not self._record_dirty)

    def _note_round(self, round_number, metric, save_dir, extra) -> None:
        """The round's row, and ``round_record.json`` flushed atomically on
        the ``record_flush_every`` cadence and in the final round (the exit
        flush is the writer's finalizer)."""
        row = {f"test_{k}": v for k, v in metric.items()}
        row.update(extra)
        if self._trace.enabled:
            # one `round` span a recorded round, on every run path; the row
            # cross-links the span's line offset
            fields = {"round": round_number, "accuracy": metric.get("accuracy"), "loss": metric.get("loss")}
            fields.update({k: extra[k] for k in ("received_mb", "sent_mb", "rejected_updates", "phase") if k in extra})
            row["trace_offset"] = self._trace.span_record("round", extra.get("round_seconds", 0.0), **fields)
        self._stat[round_number] = row
        get_logger().info(
            "round: %d, test accuracy %.4f loss %.4f (torch)",
            round_number,
            metric["accuracy"],
            metric["loss"],
        )
        self._record_path = os.path.join(save_dir, "round_record.json")
        self._record_dirty = True
        if round_number % self._record_flush_every == 0 or round_number >= self.config.round:
            self._flush_record()

    def _flush_record(self) -> None:
        if not self._record_dirty or self._record_path is None:
            return
        # the spans first: a durable row never cross-links a line that a
        # resumed recorder would number again
        self._trace.flush()
        atomic_json_dump(self._record_path, self._stat)
        self._record_dirty = False
