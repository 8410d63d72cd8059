"""Sparse uploads on one device (the port's ``parallel/spmd_sparse.py``).

Two FedAvg sessions whose clients upload less than their whole model,
with the JAX round programs' data flow and the FedAvg session's chunked
client loop (its ``_upload`` hook builds a trained client's f32 row):

* ``fed_dropout_avg`` (:class:`SpmdFedDropoutAvgSession`): each element
  of a trained client's f32 parameters is kept with probability
  ``1 - dropout_rate`` (a Bernoulli mask per leaf) and the rest are sent
  as 0.  An element's aggregation weight is the client's dataset size
  where its sent value is not 0, and the new global is
  ``num / where(den == 0, 1, den)`` with ``num = sum_c w_c * dropped_c``
  and ``den = sum_c w_c * [dropped_c != 0]``: an element every selected
  client dropped becomes 0, as in the reference.  Each client's row holds
  ``[dropped | indicator]``, so kernel K1 sums both in one pass a chunk
  over ``[mb, 2·D]``.
* ``single_model_afd`` (:class:`SpmdSMAFDSession`): error-feedback
  sparsified deltas.  Each slot keeps an f32 residual on the device
  (``[n_slots, D]``); a client uploads ``delta = trained - g + err`` with
  whole leaves dropped under the ``(1 - dropout_rate)`` share of the
  parameters (the leaves taken in a random order, in JAX key order, a
  leaf kept where it still fits, with f32 partial sums as the JAX
  session's scan), or with ``topk_ratio`` each leaf's elements of
  magnitude at least its k-th largest (ties admitted); what it did not
  send stays in its residual, and an unselected slot keeps its residual.
  The new global is ``sum_c w_c * (g + sent_c) / max(sum_c w_c, 1e-12)``
  through K1.  A client the fault plan drops or corrupts (weight 0 or
  NaN) keeps its residual.

SMAFD checkpoints its residuals with every round
(``aggregated_model/err_state.npz``: each leaf's ``[n_slots, *shape]``
rows in the JAX package's keys and layouts, tagged ``__round__``) and
restores them on resume when the tag is the resumed round; a missing or
mismatched file warns and restarts the residuals at zero, as in the JAX
package.  FedDropoutAvg checkpoints and resumes as the FedAvg session.

The keep masks and the leaf orders come from the codec's random source
(``ops/quantization.py::CodecRandom``: ``dropout_uniform`` and
``leaf_permutation``, the ``random`` entry of ``endpoint_kwargs.worker``),
by (seed, round, slot, leaf).  Neither session fuses rounds
(``round_horizon`` > 1 raises, as in the JAX package).  Their telemetry is
the FedAvg session's records, without the ``dispatch_call`` span: the JAX
classes call their round programs outside the recorder.
"""

import os

import numpy as np
import torch

from ..util.checkpoint import jax_views, rows_from_jax
from ..utils.logging import get_logger
from .spmd import SUPPORTED_ALGORITHM_KWARGS, SpmdFedAvgSession


def budget_keep(sizes: np.ndarray, threshold: np.float32, order: np.ndarray) -> np.ndarray:
    """SMAFD's whole-leaf dropout: the leaves walked in ``order``, each
    kept where the kept sizes so far plus its own stay within
    ``threshold``, the sums in f32 as the JAX session's scan takes them
    (in f64 the kept leaves can differ).  Returns the kept mask over
    ``sizes`` (f32 leaf sizes)."""
    keep = np.zeros(len(sizes), bool)
    partial = np.float32(0.0)
    for i in order:
        size = np.float32(sizes[i])
        if np.float32(partial + size) <= threshold:
            partial = np.float32(partial + size)
            keep[i] = True
    return keep


def budget_threshold(sizes: np.ndarray, dropout_rate: float) -> np.float32:
    """The parameter budget, as the JAX session computes it on the host."""
    return np.float32((1.0 - dropout_rate) * np.sum(sizes, dtype=np.float32))


class SpmdFedDropoutAvgSession(SpmdFedAvgSession):
    """fed_dropout_avg: Bernoulli element dropout of the uploads and a
    per-element weighted average."""

    supported_algorithm_kwargs = SUPPORTED_ALGORITHM_KWARGS | {"dropout_rate"}
    _upload_dtype = torch.float32

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._dropout_rate = float(self.config.algorithm_kwargs["dropout_rate"])
        # the keep probability as JAX's bernoulli compares it: an f32
        self._keep_prob = torch.tensor(np.float32(1.0 - self._dropout_rate), device=self.device)

    def _upload_cost_factor(self) -> float:
        return 1.0 - self._dropout_rate

    def _row_width(self, size: int) -> int:
        return 2 * size  # [dropped | indicator]

    def _upload(self, row, trained, start, g, aggregate: int, slot: int) -> None:
        """``row[:D]``: the trained values with each leaf's dropped elements
        0; ``row[D:]``: 1 where that value is not 0."""
        size = trained.numel()
        dropped, indicator = row[:size], row[size:]
        dropped.copy_(trained)
        count = len(self._jax_leaves)
        for i, leaf in enumerate(self._jax_leaves):
            uniform = self._random.dropout_uniform(
                self.config.seed, aggregate, slot, i, count, (leaf.size,), self.device
            )
            keep = leaf.from_jax((uniform < self._keep_prob).to(torch.float32))
            dropped[leaf.start : leaf.stop].mul_(keep)
        torch.ne(dropped, 0.0, out=indicator)  # into f32: 1.0 or 0.0

    def _finish(self, acc: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
        size = acc.numel() // 2
        num, den = acc[:size], acc[size:]
        return num / torch.where(den == 0, torch.ones_like(den), den)


class SpmdSMAFDSession(SpmdFedAvgSession):
    """single_model_afd: error-feedback sparsified delta uploads, the
    residuals on the device."""

    supported_algorithm_kwargs = SUPPORTED_ALGORITHM_KWARGS | {"dropout_rate", "topk_ratio"}
    _upload_dtype = torch.float32

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        algorithm_kwargs = self.config.algorithm_kwargs
        topk = algorithm_kwargs.get("topk_ratio")
        self._topk_ratio = None if topk is None else float(topk)
        self._dropout_rate = float(algorithm_kwargs.get("dropout_rate", 0.0))
        self._sizes = np.asarray([float(leaf.size) for leaf in self._jax_leaves], np.float32)
        self._threshold = budget_threshold(self._sizes, self._dropout_rate)
        size = self.engine.layout.size
        #: each slot's residual: what it has not sent yet
        self._err = torch.zeros(self.n_slots, size, device=self.device)
        self._keep = torch.empty(size, device=self.device)  # a client's per-element keep factor
        leaf_of = torch.empty(size, dtype=torch.long)  # each element's leaf, in JAX key order
        for i, leaf in enumerate(self._jax_leaves):
            leaf_of[leaf.start : leaf.stop] = i
        self._leaf_of = leaf_of.to(self.device)
        self._round_weight_row = None  # the round's host weight row (run_round sets it)

    def _err_path(self, base_dir: str) -> str:
        return os.path.join(base_dir, "aggregated_model", "err_state.npz")

    def _record(self, round_number, metric, global_vec, save_dir, extra) -> None:
        super()._record(round_number, metric, global_vec, save_dir, extra)
        leaves = self._jax_leaves

        def arrays(host: np.ndarray) -> dict:
            return {**jax_views(host, leaves), "__round__": np.int64(round_number)}

        self._ckpt.save_rows(self._err_path(self.config.save_dir), self._err, arrays)

    def _start(self):
        global_vec, start_round = super()._start()
        if start_round > 1:
            restored = self._load_err(str(self.config.algorithm_kwargs.get("resume_dir")), start_round - 1)
            if restored is not None:
                self._err.copy_(restored)
                get_logger().info("smafd resume: restored error-feedback residuals (round %d)", start_round - 1)
            else:
                get_logger().warning(
                    "smafd resume: err_state.npz missing or from a different round — error-feedback"
                    " residuals restart at zero"
                )
        return global_vec, start_round

    def _load_err(self, resume_dir: str, round_number: int) -> torch.Tensor | None:
        """The residuals of ``err_state.npz`` as ``[n_slots, D]`` in the
        port's layout, or None when the file is absent, of another round
        or of other keys or shapes."""
        path = self._err_path(resume_dir)
        if not os.path.isfile(path):
            return None
        with np.load(path) as blob:
            if "__round__" not in blob.files or int(blob["__round__"]) != round_number:
                return None
            loaded = {k: blob[k] for k in blob.files if k != "__round__"}
        if set(loaded) != {leaf.jax_key for leaf in self._jax_leaves}:
            return None
        err = rows_from_jax([loaded[leaf.jax_key] for leaf in self._jax_leaves], self._jax_leaves, self.n_slots)
        return None if err is None else err.to(self.device)

    def _upload_cost_factor(self) -> float:
        if self._topk_ratio is not None:
            return self._topk_ratio
        return 1.0 - self._dropout_rate

    def keep_leaves(self, aggregate: int, slot: int) -> np.ndarray:
        """The whole-leaf dropout of one upload: its kept mask over the
        leaves in JAX key order."""
        order = self._random.leaf_permutation(self.config.seed, aggregate, slot, len(self._jax_leaves))
        return budget_keep(self._sizes, self._threshold, order)

    def _upload(self, row, trained, start, g, aggregate: int, slot: int) -> None:
        """``row``: ``g + sent`` for ``delta = trained - g + err``; the
        slot's residual becomes ``delta - sent``."""
        err = self._err[slot]
        torch.sub(trained.to(torch.float32), g, out=row)
        row.add_(err)  # delta
        if self._topk_ratio is not None:
            for leaf in self._jax_leaves:
                magnitude = row[leaf.start : leaf.stop].abs()
                kth = max(1, int(leaf.size * self._topk_ratio))
                threshold = torch.topk(magnitude, kth).values[-1]
                torch.ge(magnitude, threshold, out=self._keep[leaf.start : leaf.stop])
        else:
            keep = torch.from_numpy(self.keep_leaves(aggregate, slot).astype(np.float32)).to(self.device)
            torch.index_select(keep, 0, self._leaf_of, out=self._keep)
        sent = row * self._keep
        if self._round_weight_row is None or self._round_weight_row[slot] > 0:
            torch.sub(row, sent, out=err)
        # else a corrupt (NaN-weighted) upload: the slot keeps its residual, as in JAX
        torch.add(g, sent, out=row)
