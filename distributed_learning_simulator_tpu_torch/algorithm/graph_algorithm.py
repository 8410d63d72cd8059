"""Graph FL's server algorithm (the port's copy of the JAX package's
``algorithm/graph_algorithm.py``): a round's in-round messages are either
every worker's training-node indices, unioned and sent back to each, or a
boundary exchange, in which each worker provides the embeddings of its
nodes and names the nodes it needs, and gets back the provided rows of
those.  Parameter uploads fall through to FedAvg.

The rows stay device tensors: the provided rows are concatenated once and
one ``index_select`` gathers every worker's request, which each gets as a
view; the node ids stay numpy on the host.
"""

import numpy as np
import torch

from ..message import Message
from .fed_avg_algorithm import FedAVGAlgorithm


class GraphNodeEmbeddingPassingAlgorithm(FedAVGAlgorithm):
    def __init__(self, server=None) -> None:
        super().__init__(server=server)
        self.training_node_indices: dict[int, np.ndarray] = {}

    def aggregate_worker_data(self) -> Message:
        sample = next(iter(self._all_worker_data.values()), None)
        if isinstance(sample, Message) and "training_node_indices" in sample.other_data:
            return self._exchange_training_node_indices()
        if isinstance(sample, Message) and "node_embedding" in sample.other_data:
            return self._route_node_embeddings()
        return super().aggregate_worker_data()

    def _exchange_training_node_indices(self) -> Message:
        for worker_id, data in self._all_worker_data.items():
            self.training_node_indices[worker_id] = np.asarray(data.other_data["training_node_indices"])
        merged = {w: idx.tolist() for w, idx in self.training_node_indices.items()}
        worker_result = {
            w: Message(in_round=True, other_data={"training_node_indices": merged}) for w in self._all_worker_data
        }
        return Message(in_round=True, other_data={"worker_result": worker_result})

    def _route_node_embeddings(self) -> Message:
        messages = self._all_worker_data
        rows = torch.cat([m.other_data["node_embedding"] for m in messages.values()])
        ids = np.concatenate([np.asarray(m.other_data["node_indices"], np.int64) for m in messages.values()])
        wanted = {w: np.asarray(m.other_data["boundary"], np.int64) for w, m in messages.items()}
        # each node's row among the provided ones (-1: nobody provides it)
        size = 1 + max([-1, *(int(a.max()) for a in (ids, *wanted.values()) if len(a))])
        position = np.full(size, -1, np.int64)
        position[ids] = np.arange(len(ids))
        available, picks = {}, []
        for worker_id, nodes in wanted.items():
            at = position[nodes]
            available[worker_id] = nodes[at >= 0].astype(np.int32)
            picks.append(at[at >= 0])
        gathered = rows.index_select(0, torch.from_numpy(np.concatenate(picks)).to(rows.device))
        parts = torch.split(gathered, [len(available[w]) for w in wanted])
        worker_result = {
            worker_id: Message(
                in_round=True, other_data={"node_embedding": part, "node_indices": available[worker_id]}
            )
            for worker_id, part in zip(wanted, parts)
        }
        return Message(in_round=True, other_data={"worker_result": worker_result})
