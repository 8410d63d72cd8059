"""Shapley-value methods on one device (the port's ``parallel/spmd_shapley.py``).

GTG-Shapley (``GTG_shapley_value``), multi-round (``multiround_shapley_value``)
and hierarchical (``Hierarchical_shapley_value``) Shapley values on the
FedAvg session, with the JAX round program's data flow:

1. every worker trains from the f32 global vector for ``epoch`` local epochs
   (``scan_local_epochs``, no best-epoch validation), in place in its f32
   row of an ``[n_slots, D]`` stack whose rows start on 128-byte
   boundaries.  As in the JAX program, every slot trains whatever the
   selection; nothing is reduced yet;
2. the round's engine (``shapley/``, the engine built once, in round 1)
   asks for subset metrics in batches.  A subset's parameters are kernel
   K1 over the stack with ``w = mask * weights`` (``weights`` the round's
   selection row: the selected workers' dataset sizes), divided by
   ``max(sum(w), 1e-12)``: the sum first, the division second, as in the
   JAX subset program (under a fault plan the row has the FedAvg
   session's fold: a dropped worker 0, a corrupt one NaN, which poisons
   every subset as in JAX; the round's aggregate below ignores the plan,
   as the JAX one does).  Its metric is ``correct / max(count, 1)`` in f32
   on the test set, taken ``SUBSET_EVAL_BATCH`` samples at a time: a
   subset metric is inference only, and the port's models have no batch
   statistics, so each sample's prediction (hence ``correct``) does not
   depend on the batch, while a forward at the training batch is bound by
   the host's launches (the JAX program evaluates at the training batch;
   the losses part by summation order).  Only the real subsets are
   evaluated (the JAX program pads a chunk of 16 with dummy masks).  The
   evaluator is :class:`SubsetMetrics`, which the threaded Shapley
   servers (``method/shapley_value/``) run too;
3. the new global is K1 over the stack with ``agg_mask * dataset_sizes /
   max(sum, 1e-12)``, normalised first, as the JAX aggregate: ``agg_mask``
   is every worker, or under ``choose_best_subset`` the round's best
   subset (the keys of ``shapley_values_S[round]``).

The round-0 test metric is ``_stat[0]`` (in ``round_record.json``, not in
the returned ``performance``) and seeds the engine's ``last_round_metric``.
After every round ``shapley_values.json`` and ``shapley_values_S.json`` are
rewritten under ``save_dir`` through a temp file and ``os.replace``, and
the round's global goes to ``aggregated_model/round_N.npz`` (JAX keys) on
the FedAvg session's checkpoint cadence.  The session counts the subsets
it evaluates a round (:attr:`SpmdShapleySession.round_subsets`): K1
launches once a subset and once for the round's aggregate.

``resume_dir`` resumes as the FedAvg session does; the SV records of the
rounds before the resume are brought forward with both key levels as
``int`` (a tail at or past the resume round is dropped), and the engine,
built in the first resumed round, is seeded with the last recorded
accuracy.  As in the JAX session, ``kill_after_rounds`` is ignored here:
the session arms no kill.  Its telemetry is the JAX session's: a ``round``
span a recorded round (not round 0) and the ``resume`` event.
"""

import json
import os
import time

import numpy as np
import torch

from .. import shapley
from ..engine.batching import make_epoch_batches
from ..ml_type import MachineLearningPhase as Phase
from ..models.dropout import dropout_generator
from ..ops.pytree import flat_stack_weighted_sum
from ..util.checkpoint import atomic_json_dump
from ..utils.logging import get_logger
from .spmd import SUPPORTED_ALGORITHM_KWARGS, SpmdFedAvgSession, scan_local_epochs

#: test samples a subset metric's forward takes at a time
SUBSET_EVAL_BATCH = 1024

ENGINE_FOR = {
    "GTG_shapley_value": "GTGShapleyValue",
    "multiround_shapley_value": "MultiRoundShapleyValue",
    "Hierarchical_shapley_value": "HierarchicalShapleyValue",
}


def subset_params(stack: torch.Tensor, mask: np.ndarray, weights: np.ndarray) -> torch.Tensor:
    """A subset's parameters: ``sum_c w_c * stack[c] / max(sum(w), 1e-12)``
    with ``w = mask * weights``, summed first (K1), divided second."""
    w = (mask * weights).astype(np.float32)
    total = max(float(np.sum(w, dtype=np.float32)), 1e-12)
    return flat_stack_weighted_sum(stack, torch.from_numpy(w).to(stack.device)) / total


class SubsetMetrics:
    """The engines' batch metric over a stack of the round's parameters,
    for both executors: each subset's parameters (:func:`subset_params`,
    one K1 launch) and its test accuracy (f32 ``correct / max(count, 1)``),
    ``SUBSET_EVAL_BATCH`` test samples a forward, read from the device once
    a call.  Keeps what each round evaluated."""

    def __init__(self, engine, test_dataset, stage) -> None:
        self.engine = engine
        self.batches = stage(make_epoch_batches(test_dataset, min(SUBSET_EVAL_BATCH, len(test_dataset))))
        #: round -> subsets evaluated, and the seconds they took
        self.round_subsets: dict[int, int] = {}
        self.subset_seconds: dict[int, float] = {}
        #: round -> {subset (sorted tuple): (loss_sum, correct, count)}
        self.results: dict[int, dict[tuple, tuple[float, float, float]]] = {}

    def metric_many(self, stack: torch.Tensor, weights: np.ndarray, round_number: int):
        """The batch metric of round ``round_number`` over ``stack``, whose
        rows weigh ``weights`` (a subset's mask zeroes the others')."""
        results = self.results.setdefault(round_number, {})

        def metric_many(subsets: list) -> list[float]:
            t0 = time.monotonic()
            sums = []
            for subset in subsets:
                mask = np.zeros(stack.shape[0], np.float32)
                mask[[int(w) for w in subset]] = 1.0
                params = self.engine.layout.split(subset_params(stack, mask, weights))
                summed = self.engine.evaluate(params, self.batches)
                sums.append(torch.stack([summed["loss_sum"], summed["correct"], summed["count"]]))
            host = torch.stack(sums).cpu().numpy() if sums else np.zeros((0, 3), np.float32)
            out = []
            for subset, (loss_sum, correct, count) in zip(subsets, host):
                results[tuple(sorted(int(w) for w in subset))] = (float(loss_sum), float(correct), float(count))
                out.append(float(correct / np.maximum(count, np.float32(1.0))))
            self.round_subsets[round_number] = self.round_subsets.get(round_number, 0) + len(subsets)
            self.subset_seconds[round_number] = self.subset_seconds.get(round_number, 0.0) + time.monotonic() - t0
            return out

        return metric_many


class SpmdShapleySession(SpmdFedAvgSession):
    """Per-round Shapley values of the workers from subset metrics on the
    device-resident stack of their trained parameters."""

    supported_algorithm_kwargs = SUPPORTED_ALGORITHM_KWARGS | {
        "choose_best_subset",
        "sv_kwargs",
        *shapley.HIERARCHICAL_CONFIG_KEYS,
    }
    _uses_val_policy = False  # its own round program; no val policy

    def __init__(self, config, dataset_collection, *args, **kwargs) -> None:
        super().__init__(config, dataset_collection, *args, **kwargs)
        self._subsets = SubsetMetrics(self.engine, dataset_collection.get_dataset(Phase.Test), self._to_device)
        self._engine_cls = getattr(shapley, ENGINE_FOR[self.config.distributed_algorithm])
        self._sv_engine = None
        self.shapley_values: dict[int, dict] = {}
        self.shapley_values_S: dict[int, dict] = {}
        #: round -> subsets evaluated, the seconds they took, and
        #: {subset (sorted tuple): (loss_sum, correct, count)}
        self.round_subsets = self._subsets.round_subsets
        self.subset_seconds = self._subsets.subset_seconds
        self.subset_results = self._subsets.results

    def train_stack(self, global_vec: torch.Tensor, round_number: int) -> torch.Tensor:
        """Every slot's parameters after its local epochs from ``global_vec``,
        as the f32 rows of an ``[n_slots, D]`` stack."""
        size = global_vec.numel()
        row_stride = -(-size // 64) * 64  # rows start on 128-byte boundaries
        stack = torch.empty(self.n_slots, row_stride, dtype=torch.float32, device=self.device)[:, :size]
        for slot in range(self.n_slots):
            row = stack[slot]
            row.copy_(global_vec)
            scan_local_epochs(
                self.engine,
                self.config.epoch,
                row,
                {k: v[slot] for k, v in self._data.items()},
                self._counts[slot],
                None,
                dropout_generator(self.config.seed, round_number, slot, self.device),
            )
        return stack

    def subset_params(self, stack: torch.Tensor, mask: np.ndarray, weights: np.ndarray) -> torch.Tensor:
        return subset_params(stack, mask, weights)

    def round_aggregate(self, stack: torch.Tensor, agg_mask: np.ndarray) -> torch.Tensor:
        """The new global: K1 over the stack with the dataset sizes under
        ``agg_mask``, normalised before the sum."""
        sizes = (agg_mask * self._dataset_sizes).astype(np.float32)
        w = sizes / np.float32(max(float(sizes.sum()), 1e-12))
        return flat_stack_weighted_sum(stack, torch.from_numpy(w).to(self.device))

    def _metric_many(self, stack: torch.Tensor, weights: np.ndarray, round_number: int):
        """The engine's batch metric over the stack (:class:`SubsetMetrics`)."""
        return self._subsets.metric_many(stack, weights, round_number)

    def _engine_kwargs(self) -> dict:
        return shapley.sv_engine_kwargs(
            self.config, hierarchical=self.config.distributed_algorithm == "Hierarchical_shapley_value"
        )

    def run(self) -> dict:
        config = self.config
        save_dir = os.path.join(config.save_dir, "server")
        os.makedirs(save_dir, exist_ok=True)
        global_vec, start_round = self._start()
        if start_round == 1:
            # the engine's round-0 metric (the reference's need_init_performance)
            self._stat[0] = {f"test_{k}": v for k, v in self._evaluate(global_vec).items()}
        else:
            self._restore_sv_records(start_round)
        choose_best = bool(config.algorithm_kwargs.get("choose_best_subset", False))
        with self._ckpt:  # flushes the record and drains the writes at exit, errors included
            for round_number in range(start_round, config.round + 1):
                global_vec = self._sv_round(global_vec, round_number, choose_best, save_dir)
        return {
            "performance": {k: v for k, v in self._stat.items() if k > 0},
            "sv": self.shapley_values,
            "sv_S": self.shapley_values_S,
        }

    def _sv_round(self, global_vec: torch.Tensor, round_number: int, choose_best: bool, save_dir: str):
        """One round: the stack, the engine's subset metrics, the SV
        records, the aggregate and its record; returns the new global."""
        config = self.config
        start = time.monotonic()
        # the fault plan reaches the subset metrics' weights (and the quorum), as in JAX
        weights = self._select_weights(round_number)
        stack = self._watchdog.call(
            lambda: self.train_stack(global_vec, round_number), phase="round", round_number=round_number
        )
        if self._sv_engine is None:
            # fresh: the round-0 metric; resumed: the last recorded round's
            self._sv_engine = self._engine_cls(
                players=list(range(config.worker_number)),
                last_round_metric=self._stat[max(self._stat)]["test_accuracy"],
                **self._engine_kwargs(),
            )
        metric_many = self._metric_many(stack, weights, round_number)

        def guarded_many(subsets):  # each batch of subset metrics under its own deadline
            return self._watchdog.call(lambda: metric_many(subsets), phase="eval", round_number=round_number)

        self._sv_engine.set_metric_function(lambda subset: guarded_many([subset])[0])
        self._sv_engine.set_batch_metric_function(guarded_many)
        self.round_subsets[round_number] = 0
        self._sv_engine.compute(round_number=round_number)
        # worker ids as ints: the Monte-Carlo branches' subsets hold numpy
        # integers, which json cannot take as keys (ROADMAP R11)
        for record, source in (
            (self.shapley_values, self._sv_engine.shapley_values),
            (self.shapley_values_S, self._sv_engine.shapley_values_S),
        ):
            record[round_number] = {int(w): sv for w, sv in source[round_number].items()}
        self._dump_sv()  # every round: it survives a crash and feeds a resume

        agg_mask = np.zeros(self.n_slots, np.float32)
        if choose_best and self.shapley_values_S[round_number]:
            agg_mask[[int(w) for w in self.shapley_values_S[round_number]]] = 1.0
            get_logger().info("use subset %s", sorted(self.shapley_values_S[round_number]))
        else:
            agg_mask[: config.worker_number] = 1.0
        global_vec = self.round_aggregate(stack, agg_mask)
        del stack
        metric = self._watchdog.call(lambda: self._evaluate(global_vec), phase="eval", round_number=round_number)
        extra = {
            "subsets": self.round_subsets[round_number],
            "subset_seconds": self.subset_seconds.get(round_number, 0.0),
            "round_seconds": time.monotonic() - start,
        }
        self._record(round_number, metric, global_vec, save_dir, extra)
        return global_vec

    def _restore_sv_records(self, start_round: int) -> None:
        """The resumed session's SV records (written every round, so they
        survive a crash), both key levels as ``int``; the rounds at or past
        the resume round are dropped (a superseded tail).  An unreadable
        file loses only its SV history."""
        resume_dir = self.config.algorithm_kwargs.get("resume_dir")
        for name, target in (
            ("shapley_values.json", self.shapley_values),
            ("shapley_values_S.json", self.shapley_values_S),
        ):
            path = os.path.join(resume_dir, name)
            if not os.path.isfile(path):
                continue
            try:
                with open(path, encoding="utf8") as f:
                    target.update({int(k): {int(w): sv for w, sv in v.items()} for k, v in json.load(f).items()})
            except (json.JSONDecodeError, ValueError, AttributeError, TypeError):
                get_logger().warning("unreadable %s; resuming without its SV history", path)
        for records in (self.shapley_values, self.shapley_values_S):
            for k in [k for k in records if k >= start_round]:
                del records[k]
        get_logger().info(
            "resumed shapley session at round %d (%d SV rounds restored)", start_round, len(self.shapley_values)
        )

    def _dump_sv(self) -> None:
        """Both SV records, rewritten after every round through a temp file
        and ``os.replace`` (a crash mid-write leaves the last whole file)."""
        for name, source in (
            ("shapley_values.json", self.shapley_values),
            ("shapley_values_S.json", self.shapley_values_S),
        ):
            atomic_json_dump(os.path.join(self.config.save_dir, name), {str(k): v for k, v in source.items()})
