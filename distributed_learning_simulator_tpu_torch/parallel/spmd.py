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

The sparse-upload sessions (``parallel/spmd_sparse.py``) reuse the client
loop through :meth:`SpmdFedAvgSession._upload` (a trained client's row),
``_row_width``, ``_upload_dtype`` and ``_finish`` (the new master).
"""

import json
import math
import os
import time

import numpy as np
import torch

from ..config import DistributedTrainingConfig
from ..engine.batching import fixed_size_partition, make_epoch_batches, stage_batches
from ..engine.engine import ComputeEngine, maybe_slow_metrics, summarize_metrics
from ..ml_type import MachineLearningPhase as Phase
from ..models.convert import from_jax, jax_leaves, to_jax
from ..models.dropout import dropout_generator
from ..models.registry import causal_lm_targets
from ..ops.pytree import flat_stack_weighted_sum
from ..ops.quantization import CodecRandom, qsgd_quantize_dequantize
from ..utils.logging import get_logger
from ..utils.selection import select_workers

#: algorithm_kwargs this session reads; any other key raises
SUPPORTED_ALGORITHM_KWARGS = frozenset(
    {"client_chunk", "global_model_path", "random_client_number", "round_horizon"}
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
        self.client_chunk = int(config.algorithm_kwargs.get("client_chunk", 0) or 0)
        self._stat: dict[int, dict] = {}

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

    def _init_global_params(self) -> torch.Tensor:
        """The f32 master as one flat vector: ``global_model_path`` (an npz
        of JAX parameters, through the weight bridge) or a fresh init."""
        init_path = self.config.algorithm_kwargs.get("global_model_path")
        if init_path:
            with np.load(init_path) as blob:
                params = from_jax({k: blob[k] for k in blob.files})
        else:
            params = self.engine.init_params(self.config.seed)
        params = {k: v.to(self.device, torch.float32) for k, v in params.items()}
        return self.engine.layout.flatten(params)

    #: the rows' dtype (None: the compute dtype, as the client trained)
    _upload_dtype: torch.dtype | None = None

    def _row_width(self, size: int) -> int:
        """Values in a client's row of the K1 input for ``size`` parameters."""
        return size

    def run_round(
        self, global_vec: torch.Tensor, weights: np.ndarray, round_number: int = 1
    ) -> torch.Tensor:
        """One round: the new f32 master from ``global_vec``."""
        engine = self.engine
        start = global_vec.to(self.model_ctx.compute_dtype)  # once per round
        work = torch.empty_like(start)
        mb = self.chunk_size()
        width = self._row_width(global_vec.numel())
        # rows start on 128-byte boundaries, so K1 reads 16-byte vectors
        row_stride = -(-width // 64) * 64
        rows = torch.empty(mb, row_stride, dtype=self._upload_dtype or start.dtype, device=self.device)
        rows = rows[:, :width]
        acc = torch.zeros(width, device=self.device)
        w = torch.from_numpy(weights).to(self.device)  # one host->device copy a round
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
            acc += flat_stack_weighted_sum(rows, w[c0 : c0 + mb])
        return self._finish(acc, weights)

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
        global_vec = self._init_global_params()
        save_dir = os.path.join(config.save_dir, "server")
        os.makedirs(save_dir, exist_ok=True)
        param_mb = global_vec.numel() * 4 / 1e6
        for round_number in range(1, config.round + 1):
            start = time.monotonic()
            weights = self._base_weight_row(round_number)
            global_vec = self.run_round(global_vec, weights, round_number)
            metric = self._evaluate(global_vec)  # reads the metrics: the round's one sync
            selected = int((weights > 0).sum())
            self._note_round(
                round_number,
                metric,
                save_dir,
                {
                    "received_mb": selected * param_mb * self._upload_cost_factor(),
                    "sent_mb": selected * param_mb,
                    "round_seconds": time.monotonic() - start,
                },
            )
        # the exit state, in the JAX package's keys and layout
        model_dir = os.path.join(config.save_dir, "aggregated_model")
        os.makedirs(model_dir, exist_ok=True)
        np.savez(
            os.path.join(model_dir, f"round_{config.round}.npz"),
            **to_jax(self.engine.layout.split(global_vec)),
        )
        return {"performance": self._stat}

    def _note_round(self, round_number, metric, save_dir, extra) -> None:
        row = {f"test_{k}": v for k, v in metric.items()}
        row.update(extra)
        self._stat[round_number] = row
        get_logger().info(
            "round: %d, test accuracy %.4f loss %.4f (torch)",
            round_number,
            metric["accuracy"],
            metric["loss"],
        )
        path = os.path.join(save_dir, "round_record.json")
        with open(path + ".tmp", "w", encoding="utf8") as f:
            json.dump(self._stat, f)
        os.replace(path + ".tmp", path)
