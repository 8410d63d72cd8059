"""FedOBD on one device (the port's ``parallel/spmd_obd.py``).

The JAX session compiles each FedOBD phase into one program over the
clients axis; here the clients are the FedAvg session's chunked loop,
with the JAX phase programs' data flow:

* **phase 1** (``block_dropout_rounds``, ``round`` aggregates): the
  selected clients train ``epoch`` epochs from the broadcast with a fresh
  optimizer each; each client's blocks (``get_module_blocks``) are ranked
  by the L2 norm of their change over their size and kept greedily under
  the ``(1 - dropout_rate)`` share of the parameters (a stable sort, one
  device-to-host read of the scores a client); a kept leaf uploads
  ``g + codec(p - g)``, a dropped one the broadcast ``g``;
* **phase 2** (``epoch_tune``, ``second_phase_epoch`` aggregates): every
  client trains one epoch a aggregate from its carried optimizer state
  and uploads ``g + codec(p - g)`` for every leaf;
* the f32 uploads are summed through kernel K1 a chunk at a time, and the
  exact average is evaluated and recorded; the next aggregate trains
  from the codec's broadcast of it (``quant_broadcast``).

The codec is NNADQ for fed_obd and QSGD for fed_obd_sq
(``ops/quantization.py``: value distortion without packing); wire sizes
come from the bits it chose.  Deltas and scores are taken against the
f32 broadcast, training from one compute-dtype cast of it (bf16 under
``use_amp``).  Each slot keeps the optimizer state of its last
participation; phase 2 seeds from those (a fresh state for a client never
selected) and carries them through every epoch.  The phases follow the
same ``ObdRoundDriver`` the threaded server consults.

``round_horizon`` H > 1 (the JAX session's fused dispatch of H
aggregates of one phase, clamped to the phase's budget) runs aggregate by
aggregate, as the FedAvg session does: the H = 1 run, bit for bit, every
phase switch on a horizon boundary, and the checkpoints on the JAX
session's boundaries.  With ``early_stop`` it warns and runs per round,
as the JAX session falls back to per-round running.

Each checkpointed aggregate writes the exact average to
``aggregated_model/round_<key>.npz``.  ``opt_state.npz`` holds the
per-slot optimizer states (``leaf_{i}``: the momentum trace of each JAX
leaf as ``[n_slots, *shape]``, then the ``[n_slots]`` int32 step counts;
``stat_key``: the aggregate's key), the JAX package's keys and shapes; it
is written at the switch into phase 2, after every phase-2 aggregate and,
when ``random_client_number`` leaves clients out, after every phase-1
aggregate.  ``resume_dir`` restores the record, replays the phase driver
over its phases (``method/fed_obd/driver.py::replay_resume``), drops a
tail of a superseded schedule and reloads the last kept aggregate, and
restores the optimizer states saved with it.  Unlike the JAX session,
which trains the next aggregate from the restored exact average, the port
codes the restored average again (the codec's draws are keyed by the
aggregate), so the first resumed aggregate trains from the broadcast an
uninterrupted run would have sent: a resume is the uninterrupted run, bit
for bit.

The fault plan folds into each aggregate's weight row as in the JAX
session (phase 1 keyed by the round, phase 2 by the aggregate's key): a
dropped client weighs 0 and a corrupt one NaN, but both still train (a
lost upload, not a missed round), so under a selection a slot's phase-2
seed is the state of its last participation that counted, and its
upload's bits do not count.  The update guard checks each client's coded
upload against the broadcast on the device (finite, and within
``max_update_norm``) and zeroes a rejected client's weight; the
survivors' total divides the sum, a round that rejects everyone keeps the
broadcast, and the row's ``rejected_updates`` meets the post-guard quorum.
The kill fires where the JAX session fires it.

Telemetry follows the JAX session's phase loop: per aggregate a
``dispatch_call`` span under the JAX phase program's name (``phase1[dense]``,
``phase1[gather]`` under ``random_client_number``, ``phase2[dense]``;
``obd_horizon[phase1,h=N]`` and ``obd_horizon[phase2,h=N]`` at H > 1), the
``dispatch`` event of the phase (``round`` / ``round-phase2``), an ``eval``
span, ``eval``'s dispatch, ``host_sync``, ``hbm`` and the ``round`` span
(its ``phase`` field the phase's name); a ``horizon`` span a chunk at H > 1
(the port's aggregates still make the H = 1 dispatches and syncs), and a
``phase_switch`` event at each switch.  The JAX session's ``writeback``
spans belong to its streamed population store, which the port does not
have.
"""

import math
import os
import time

import numpy as np
import torch

from ..engine.hyper_parameter import SGDState
from ..method.fed_obd.driver import ObdRoundDriver, replay_resume
from ..method.fed_obd.obd_algorithm import get_module_blocks
from ..models.dropout import dropout_generator
from ..ops.pytree import flat_stack_weighted_sum
from ..ops.quantization import nnadq_quantize_dequantize_leaves, qsgd_quantize_dequantize_leaves
from ..util.checkpoint import jax_views, rows_from_jax
from ..util.faults import apply_fault_plan
from ..util.resume import load_resume_state, load_round_checkpoint
from ..utils.logging import get_logger
from .spmd import SUPPORTED_ALGORITHM_KWARGS, SpmdFedAvgSession, scan_local_epochs_carry


class SpmdFedOBDSession(SpmdFedAvgSession):
    """Two-phase FedOBD: block dropout and a quantized transport.
    ``codec`` is ``"nnadq"`` (fed_obd) or ``"qsgd"`` (fed_obd_sq)."""

    supported_algorithm_kwargs = SUPPORTED_ALGORITHM_KWARGS | {"dropout_rate", "second_phase_epoch", "early_stop"}
    _uses_val_policy = False

    @classmethod
    def _horizon_unsupported_reason(cls) -> str | None:
        return None  # the phases fuse (JAX: the session's own horizon programs)

    @classmethod
    def _class_update_guard_reason(cls) -> str | None:
        return None  # the JAX session guards its phases

    def __init__(self, *args, codec: str = "nnadq", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if codec not in ("nnadq", "qsgd"):
            raise ValueError(f"unknown FedOBD codec {codec!r}")
        self._codec = codec
        config = self.config
        worker = config.endpoint_kwargs.get("worker", {})
        self._nnadq_weight = float(worker.get("weight", 0.01))
        self._level = int(worker.get("quantization_level", 255))
        # QSGD's wire: the level plane and the signs
        self._qsgd_bits = torch.tensor(float(math.ceil(math.log2(self._level + 1)) + 1), device=self.device)
        self._dropout_rate = float(config.algorithm_kwargs["dropout_rate"])
        # the static block structure, with the sizes and the budget in f32
        blocks = get_module_blocks(list(self.engine.layout.keys))
        block_of = {key: i for i, block in enumerate(blocks) for key in block}
        self._block_sizes = np.zeros(len(blocks), np.float32)
        for leaf in self._jax_leaves:
            self._block_sizes[block_of[leaf.key]] += leaf.size
        self._leaf_block = [block_of[leaf.key] for leaf in self._jax_leaves]
        self._total_params = float(self._block_sizes.sum())
        # the codecs take every leaf of a message at once, in the layout's order
        self._layout_order = sorted(range(len(self._jax_leaves)), key=lambda i: self._jax_leaves[i].start)
        self._layout_lengths = [self._jax_leaves[i].size for i in self._layout_order]
        self._layout_position = np.argsort(self._layout_order)  # JAX index -> layout position
        self._layout_sizes = torch.tensor(self._layout_lengths, dtype=torch.float32, device=self.device)
        self._threshold = np.float32((1.0 - self._dropout_rate) * self._total_params)
        #: each slot's optimizer state after its last participation (None: never)
        self._opt_states: list = [None] * self.n_slots
        self._aggregates = 0  # aggregates run so far: the codec draws' stream

    # ------------------------------------------------------------ codec
    def _code(self, x: torch.Tensor, aggregate: int, slot: int | None, kept: list[int]):
        """A message through the codec, every leaf at once: ``x`` a flat f32
        vector in the port's layout, ``kept`` the leaves (JAX indices) that
        travel, ``slot`` the sender (None: the broadcast).  Returns
        ``(dequantized, each leaf's bits a value in layout order)``; the
        values of leaves not kept are undefined.  QSGD draws each kept
        leaf's uniforms in the JAX layout's flat order."""
        if self._codec == "nnadq":
            return nnadq_quantize_dequantize_leaves(x, self._layout_lengths, self._nnadq_weight)
        uniform = torch.zeros_like(x)
        for i in kept:
            leaf = self._jax_leaves[i]
            drawn = self._random.session_uniform(
                self.config.seed, aggregate, slot, i, len(self._jax_leaves), (leaf.size,), self.device
            )
            uniform[leaf.start : leaf.stop] = leaf.from_jax(drawn.to(self.device))
        coded = qsgd_quantize_dequantize_leaves(x, uniform, self._layout_lengths, self._level)
        return coded, self._qsgd_bits.expand(len(self._jax_leaves))

    def keep_blocks(self, delta: torch.Tensor) -> np.ndarray:
        """The greedy block selection under the parameter budget for one
        client's f32 change ``delta``: blocks in descending order of
        ``||delta_block|| / size`` (a stable sort: ties keep block order),
        each kept where it still fits, the walk going on past blocks that
        do not.  Returns the kept mask over blocks."""
        sq_leaf = torch.stack([delta[leaf.start : leaf.stop].square().sum() for leaf in self._jax_leaves])
        sq_leaf = sq_leaf.cpu().numpy()  # the client's one device-to-host read
        sq = np.zeros(len(self._block_sizes), np.float32)
        for block, value in zip(self._leaf_block, sq_leaf):
            sq[block] += value
        score = np.sqrt(sq) / self._block_sizes
        keep = np.zeros(len(self._block_sizes), bool)
        partial = np.float32(0.0)
        for block in np.argsort(-score, kind="stable"):
            size = self._block_sizes[block]
            if partial + size <= self._threshold:
                partial = np.float32(partial + size)
                keep[block] = True
        return keep

    def _message_bits(self, leaf_bits: torch.Tensor, kept: list[int]) -> torch.Tensor:
        """A message's bits from each leaf's bits a value (layout order) over
        the ``kept`` leaves (JAX indices, in JAX order), summed in f32 in
        that order as the JAX session sums them."""
        weighted = leaf_bits * self._layout_sizes
        bits = torch.zeros((), device=self.device)
        for i in kept:
            bits += weighted[int(self._layout_position[i])]
        return bits

    def _obd_upload(self, row: torch.Tensor, work: torch.Tensor, g: torch.Tensor, phase_two: bool,
                aggregate: int, slot: int) -> torch.Tensor:
        """A client's f32 upload into ``row`` from its trained ``work``
        against the f32 broadcast ``g``: kept leaves (every leaf in phase
        2) as ``g + codec(p - g)``, dropped ones as ``g``.  Returns the
        upload's bits (an f32 scalar on the device)."""
        torch.sub(work.to(torch.float32), g, out=row)  # the change, then the upload in place
        keep = None if phase_two else self.keep_blocks(row)
        kept = [i for i in range(len(self._jax_leaves)) if keep is None or keep[self._leaf_block[i]]]
        coded, leaf_bits = self._code(row, aggregate, slot, kept)
        torch.add(g, coded, out=row)
        for i in sorted(set(range(len(self._jax_leaves))) - set(kept)):
            leaf = self._jax_leaves[i]
            row[leaf.start : leaf.stop] = g[leaf.start : leaf.stop]
        return self._message_bits(leaf_bits, kept)

    # ------------------------------------------------------------ one aggregate
    @torch.no_grad()
    def _broadcast(self, exact: torch.Tensor, aggregate: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The codec's broadcast of the exact average and its bits."""
        every = list(range(len(self._jax_leaves)))
        bcast, leaf_bits = self._code(exact, aggregate, None, every)
        return bcast, self._message_bits(leaf_bits, every)

    def run_aggregate(self, g: torch.Tensor, weights: np.ndarray, key: int, phase_two: bool, trains=None):
        """One aggregate from the f32 broadcast ``g``: every slot of
        ``trains`` (default: weight not 0) trains (phase 1: ``epoch`` epochs
        from a fresh optimizer; phase 2: one epoch from its carried state)
        and uploads with its entry of ``weights`` (the fault plan's row: 0
        dropped, NaN corrupt), K1 sums the uploads a chunk at a time, and
        the exact average is coded for the next broadcast.  Under the
        update guard a rejected upload weighs 0 and the survivors' total
        divides the sum (a round that rejects everyone keeps ``g``).
        Returns ``(exact, broadcast, upload bits, broadcast bits)``, the
        bits as f32 scalars on the device."""
        engine, config = self.engine, self.config
        aggregate = self._aggregates
        if trains is None:
            trains = weights != 0
        # a phase-1 slot's state seeds its phase 2 only from a participation
        # that counted (the JAX session's masked merge under a selection)
        merge = not phase_two and self._selection_active
        start = g.to(self.model_ctx.compute_dtype)  # once per aggregate
        work = torch.empty_like(start)
        mb = self.chunk_size()
        size = g.numel()
        row_stride = -(-size // 64) * 64  # 128-byte row starts for K1's 16-byte loads
        rows = torch.empty(mb, row_stride, device=self.device)[:, :size]
        acc = torch.zeros_like(g)
        upload_bits = torch.zeros((), device=self.device)
        w = torch.from_numpy(weights).to(self.device, copy=True)  # the guard writes to it
        if self._update_guard:
            self._rejected = torch.zeros((), device=self.device)
        epochs = 1 if phase_two else config.epoch
        for c0 in range(0, self.n_slots, mb):
            for j in range(mb):
                slot = c0 + j
                if not trains[slot]:  # contributes exactly 0
                    rows[j].zero_()
                    continue
                work.copy_(start)
                state, _ = scan_local_epochs_carry(
                    engine,
                    epochs,
                    work,
                    {k: v[slot] for k, v in self._data.items()},
                    self._counts[slot],
                    self._opt_states[slot] if phase_two else None,
                    generator=dropout_generator(config.seed, key, slot, self.device),
                )
                if not merge or weights[slot] > 0:
                    self._opt_states[slot] = state
                with torch.no_grad():
                    bits = self._obd_upload(rows[j], work, g, phase_two, aggregate, slot)
                    if weights[slot] > 0:  # a dropped or corrupt upload's bits do not count
                        upload_bits += bits
                    if self._update_guard:
                        self._guard(rows[j], g, w, slot)
            acc += flat_stack_weighted_sum(rows, w[c0 : c0 + mb])
        if self._update_guard:
            total = w.sum()
            exact = torch.where(total > 0, acc / torch.clamp(total, min=1e-12), g)
        else:
            exact = acc / max(float(weights.sum()), 1e-12)
        bcast, bcast_bits = self._broadcast(exact, aggregate)
        self._aggregates += 1
        return exact, bcast, upload_bits, bcast_bits

    # ------------------------------------------------------------ the run
    def _all_weights(self) -> np.ndarray:
        """Phase 2's weights: every worker at its dataset size."""
        weights = np.asarray(self._dataset_sizes, np.float32).copy()
        weights[self.config.worker_number :] = 0.0
        return weights

    def _aggregate_weights(self, key: int, phase_two: bool) -> tuple[np.ndarray, np.ndarray]:
        """The aggregate's fault-folded weight row (its quorum enforced) and
        the slots that train: phase 1 the selected ones, phase 2 every
        worker, whatever the plan dropped (a dropped client trained and
        lost its upload)."""
        base = self._all_weights() if phase_two else self._base_weight_row(key)
        folded = apply_fault_plan(
            self._fault_plan, self._min_quorum, key, None, base.copy(), self.config.worker_number
        )
        return folded, base > 0

    def run(self) -> dict:
        """The phases off :class:`ObdRoundDriver`: phase-1 keys are the
        round numbers, phase-2 keys continue from the largest recorded."""
        config = self.config
        save_dir = os.path.join(config.save_dir, "server")
        os.makedirs(save_dir, exist_ok=True)
        driver = ObdRoundDriver.from_config(config)
        fused = self.round_horizon > 1
        if fused and driver.early_stop:
            get_logger().warning(
                "round_horizon=%d with early_stop: the plateau decision needs each round's test"
                " metric on host before the next round may run — running per-round (H=1)",
                self.round_horizon,
            )
            fused = False
        train_vec, tick = self._init_obd(driver)
        trace = self._trace
        with self._ckpt:  # flushes the record and drains the writes at exit, errors included
            while not driver.finished:
                spec = driver.phase
                phase_two = not spec.block_dropout
                # the JAX session's chunk of one phase, clamped to its budget
                h = max(1, min(self.round_horizon, driver.remaining)) if fused else 1
                if phase_two:
                    base = max(self._stat) if self._stat else 0
                    keys = [base + i + 1 for i in range(h)]
                else:
                    keys = [tick + i + 1 for i in range(h)]
                    tick += h
                label = "round-phase2" if phase_two else "round"
                program = self._phase_program(phase_two, h)
                trace.maybe_profile_start(keys[0], keys[-1])
                chunk_start = time.monotonic()
                for key in keys:
                    weights, trains = self._aggregate_weights(key, phase_two)
                    round_start = time.monotonic()
                    exact, train_vec, upload_bits, bcast_bits = self._watchdog.call(
                        lambda g=train_vec, w=weights, k=key, t=trains: trace.dispatch(
                            program, self.run_aggregate, (g, w, k, phase_two, t), cost_args=(g, w, self._data)
                        ),
                        phase=label,
                        round_number=key,
                    )
                    trace.event("dispatch", program=label, round=key)
                    # the exact average; reads the metrics: the aggregate's sync
                    with trace.span("eval", round=key):
                        metric = self._watchdog.call(lambda e=exact: self._evaluate(e), phase="eval", round_number=key)
                    trace.event("dispatch", program="eval", round=key)
                    trace.event("host_sync", round=key)
                    trace.hbm_watermark(key)
                    trace.count("rounds")
                    rejected = int(self._rejected) if self._update_guard else 0  # ready: the evaluation synced
                    self._trace_fault_event(
                        key, rejected, selected=range(config.worker_number) if phase_two else None
                    )
                    self._record_obd(
                        key, metric, float(upload_bits), float(bcast_bits), exact if key == keys[-1] else None,
                        save_dir, spec.name, time.monotonic() - round_start,
                        rejected=rejected if self._update_guard else None,
                    )
                    self._post_guard_quorum(key, int((weights != 0).sum()), rejected)
                    improved = self._has_improvement() if driver.early_stop else True
                    decision = driver.after_aggregate(improved=improved, check_acc=spec.check_acc)
                if h > 1:
                    trace.span_record(
                        "horizon", time.monotonic() - chunk_start, first_round=keys[0], last_round=keys[-1],
                        rounds=h, phase=spec.name,
                    )
                if decision.annotations or phase_two or self._selection_active:
                    self._save_opt_state(keys[-1])
                if decision.annotations:
                    get_logger().info("phase switch -> %s", driver.phase and driver.phase.name)
                    trace.event("phase_switch", round=keys[-1], phase=driver.phase.name if driver.phase else "end")
                # after the chunk's records, checkpoint and optimizer states are queued
                self._maybe_kill(keys[0], keys[-1])
                trace.maybe_profile_stop(keys[-1])
                if decision.end_training:
                    break
        return {"performance": self._stat}

    def _phase_program(self, phase_two: bool, horizon: int) -> str:
        """The JAX session's name of a phase program: its horizon program
        for a chunk of ``horizon`` > 1 aggregates, else the phase's own."""
        phase = "phase2" if phase_two else "phase1"
        if horizon > 1:
            return f"obd_horizon[{phase},h={horizon}]"
        return f"{phase}[gather]" if self._jax_gathers() and not phase_two else f"{phase}[dense]"

    @property
    def _selection_active(self) -> bool:
        """Whether ``random_client_number`` leaves clients out of phase 1:
        then a slot's phase-2 seed is the state of its last participation,
        saved with every phase-1 aggregate."""
        return self._selected_count < self.config.worker_number

    def _init_obd(self, driver) -> tuple[torch.Tensor, int]:
        """The broadcast the next aggregate trains from and the phase-1
        rounds done: fresh, or the resume of ``resume_dir`` (the module
        docstring)."""
        resume_dir = self.config.algorithm_kwargs.get("resume_dir")
        params = None
        if resume_dir:
            params, entries, _last = load_resume_state(resume_dir)
            if params is None:
                get_logger().warning("nothing resumable under %s; starting fresh", resume_dir)
        if params is None:
            return self._init_global_params(), 0
        kept_keys, phase1_ticks = replay_resume(driver, entries)
        self._stat = {k: entries[k] for k in kept_keys}
        if 0 in entries:
            self._stat[0] = entries[0]
        if kept_keys and len(kept_keys) < len([k for k in entries if k > 0]):
            # training continues from the last KEPT aggregate, not the superseded schedule's end
            kept_params = load_round_checkpoint(resume_dir, kept_keys[-1])
            if kept_params is not None:
                params = kept_params
        self._max_acc = max((s.get("test_accuracy", 0.0) for s in self._stat.values()), default=0.0)
        exact = self._master_from_jax(params)
        self._aggregates = len(kept_keys)
        if kept_keys and driver.phase is not None and (not driver.phase.block_dropout or self._selection_active):
            self._load_opt_state(resume_dir, kept_keys[-1])
        get_logger().info(
            "resumed fed_obd from %s: %d aggregates replayed, phase now %s",
            resume_dir, len(kept_keys), driver.phase.name if driver.phase else "finished",
        )
        if not kept_keys:
            return exact, phase1_ticks
        bcast, _ = self._broadcast(exact, self._aggregates - 1)
        return bcast, phase1_ticks

    def _save_opt_state(self, stat_key: int) -> None:
        """Queue ``opt_state.npz``: every slot's optimizer state (a slot
        that never trained: the fresh state) in the JAX package's keys."""
        path = os.path.join(self.config.save_dir, "aggregated_model", "opt_state.npz")
        leaves = self._jax_leaves
        counts = np.asarray([0 if st is None else st.count for st in self._opt_states], np.int32)
        tail = {"stat_key": np.int64(stat_key)}
        if not self.engine.optimizer.momentum:
            self._ckpt.save_npz(path, {"leaf_0": counts, **tail})
            return

        def arrays(host: np.ndarray) -> dict:
            views = jax_views(host, leaves)
            out = {f"leaf_{i}": views[leaf.jax_key] for i, leaf in enumerate(leaves)}
            return {**out, f"leaf_{len(leaves)}": counts, **tail}

        self._ckpt.save_rows(path, [None if st is None else st.trace for st in self._opt_states], arrays)

    def _load_opt_state(self, resume_dir: str, expect_key: int) -> None:
        """The optimizer states of ``opt_state.npz`` when they belong to
        aggregate ``expect_key`` and match the optimizer's keys and shapes;
        else the slots keep fresh states (a warning where they mismatch)."""
        path = os.path.join(resume_dir, "aggregated_model", "opt_state.npz")
        if not os.path.isfile(path):
            return
        with np.load(path) as blob:
            if int(blob["stat_key"]) != expect_key:
                return
            loaded = {k: blob[k] for k in blob.files if k != "stat_key"}
        momentum = bool(self.engine.optimizer.momentum)
        leaves = self._jax_leaves if momentum else []
        if len(loaded) != len(leaves) + 1:
            get_logger().warning("opt_state.npz does not match the optimizer")
            return
        counts = loaded[f"leaf_{len(leaves)}"]
        if counts.shape != (self.n_slots,):
            get_logger().warning("opt_state.npz leaf %d shape mismatch", len(leaves))
            return
        traces = None
        if momentum:
            traces = rows_from_jax([loaded[f"leaf_{i}"] for i in range(len(leaves))], leaves, self.n_slots)
            if traces is None:
                get_logger().warning("opt_state.npz leaf shapes mismatch the optimizer")
                return
            traces = traces.to(self.device, self.model_ctx.compute_dtype)
        self._opt_states = [
            SGDState(trace=None if traces is None else traces[slot].clone(), count=int(counts[slot]))
            for slot in range(self.n_slots)
        ]
        get_logger().info("restored phase-2 optimizer states (aggregate %d)", expect_key)

    def _record_obd(
        self, key, metric, upload_bits, bcast_bits, exact, save_dir, phase_name, round_seconds, rejected=None
    ) -> None:
        """The aggregate's row (its ``phase`` lets a resume replay the
        driver; ``rejected_updates`` under the guard) and, with ``exact``
        (None mid-horizon), its checkpoint."""
        mb = 1 / 8e6
        extra = {
            "received_mb": upload_bits * mb,
            "sent_mb": bcast_bits * mb,
            "round_seconds": round_seconds,
            "phase": phase_name,
        }
        if rejected is not None:
            extra["rejected_updates"] = float(rejected)
        self._record(key, metric, exact, save_dir, extra)
        if upload_bits:
            # wire bits over full-precision full-model bits per selected client
            get_logger().info(
                "wire ratio %.4f", upload_bits / (self._total_params * 32 * max(1, self._selected_count))
            )

    @property
    def _selected_count(self) -> int:
        n = self.config.algorithm_kwargs.get("random_client_number")
        return int(n) if n else self.config.worker_number

    def _has_improvement(self) -> bool:
        """The 5-point plateau test on test accuracy: the last five do not
        beat everything before them."""
        accs = [s["test_accuracy"] for s in self._stat.values()]
        if len(accs) < 6:
            return True
        return max(accs[-5:]) > max(accs[:-5])
