"""The single_model_afd client: whole-tensor dropout of the error-fed
delta, or with ``algorithm_kwargs.topk_ratio`` each tensor's
``max(1, int(size * ratio))`` elements of largest magnitude (ties to the
lower index of the JAX layout, as the JAX package's native top-k breaks
them).  A round with the reserved :class:`~...ops.quantization.SessionKey`
drops as the SMAFD session does (``parallel/spmd_sparse.py``): the leaves
in ``CodecRandom.leaf_permutation``'s order over the JAX key order, each
kept where the kept sizes stay within the f32 budget; a round without one
falls back to :class:`~...algorithm.random_dropout_algorithm.RandomDropoutAlgorithm`.
Logs ``send_num``, the values sent, for the analysis's cost model."""

from typing import Any

import numpy as np
import torch

from ...algorithm.random_dropout_algorithm import RandomDropoutAlgorithm
from ...message import Params
from ...models.convert import jax_leaves
from ...parallel.spmd_sparse import budget_keep, budget_threshold
from ...utils.logging import get_logger
from ...worker.error_feedback_worker import ErrorFeedbackWorker


class SingleModelAFDWorker(ErrorFeedbackWorker):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        topk = self.config.algorithm_kwargs.get("topk_ratio")
        self._topk_ratio = None if topk is None else float(topk)
        self._dropout_rate = float(self.config.algorithm_kwargs.get("dropout_rate", 0.0))
        self._dropout = RandomDropoutAlgorithm(self._dropout_rate, seed=self.config.seed * 31 + self.worker_id)

    def _leaves(self):
        layout = self.trainer.engine.layout
        return jax_leaves(layout.keys, layout.shapes)

    def _topk_sparsify(self, delta: Params) -> Params:
        sent = {}
        for leaf in self._leaves():
            flat = leaf.to_jax(delta[leaf.key].reshape(-1))
            k = max(1, int(leaf.size * self._topk_ratio))
            kept = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
            dense = torch.zeros_like(flat)
            dense[kept] = flat[kept]
            sent[leaf.key] = leaf.from_jax(dense).reshape(leaf.shape)
        return sent

    def _aligned_dropout(self, delta: Params, key) -> Params:
        leaves = self._leaves()
        sizes = np.asarray([float(leaf.size) for leaf in leaves], np.float32)
        order = self._endpoint.random.leaf_permutation(key.seed, key.aggregate, key.slot, len(leaves))
        keep = budget_keep(sizes, budget_threshold(sizes, self._dropout_rate), order)
        kept = {leaf.key for leaf, k in zip(leaves, keep) if k}
        return {name: value for name, value in delta.items() if name in kept}

    def _sparsify(self, delta: Params) -> Params:
        key = self.trainer.reserved_quant_key
        if self._topk_ratio is not None:
            sent = self._topk_sparsify(delta)
            send_num = sum(max(1, int(v.numel() * self._topk_ratio)) for v in delta.values())
        elif key is not None:
            sent = self._aligned_dropout(delta, key)
            send_num = sum(v.numel() for v in sent.values())
        else:
            sent = self._dropout.drop_parameters(delta)
            send_num = sum(v.numel() for v in sent.values())
        get_logger().info("send_num %s", send_num)
        return sent
