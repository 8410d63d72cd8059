"""The graph FL client (the port's copy of the JAX package's
``worker/graph_worker.py``): a worker owns one subgraph of a single static
graph.

* Before its first round it drops its test and validation splits, sends
  its training-node indices through the server and receives the others',
  and prunes the edge list into masks: ``local`` (both ends its own) and
  ``cross`` (``local`` and the edges to another worker's training node that
  survive ``edge_drop_rate``, drawn from ``default_rng(seed * 131 +
  worker_id)``).  It provides the embeddings of its nodes on kept cross
  edges and asks for those of the other workers' nodes there.
  ``batch_number`` and ``num_neighbor`` go to the trainer's data loader.
* Under ``share_feature`` each step is :meth:`GraphWorker._shared_feature_step`,
  an ``OPTIMIZER_STEP`` hook: an eval-mode forward through the model's
  stages (``models/graph.py::mp_stage``) with an exchange through the
  server before every message-passing stage after the first
  (``num_mp_layers - 1`` barriers of every worker a step), then the
  training forward and backward with the received rows replayed, detached
  (the JAX ``stop_gradient``), and one SGD step.  The rows stay on the
  device: the worker sends ``h.index_select`` of its provided nodes, and
  writes what it receives with ``index_copy_``; only the node ids are
  numpy.
* ``graph_worker_stat.json`` holds ``communicated_bytes`` (each payload's
  bytes as the JAX package's ``param_nbytes`` counts them, ids included,
  plus the rows received), ``exchange_count``, the boundary's size, the
  kept edges and the owned training nodes.

A graph worker trains the trainer's own per-epoch stream (the minibatches
shuffled from ``seed * 100003 + epoch``), as the JAX roles do.
"""

import json
import os
from typing import Any

import numpy as np
import torch

from ..message import Message, payload_nbytes
from ..ml_type import ExecutorHookPoint, MachineLearningPhase, StopExecutingException
from ..models.registry import masked_ce_loss
from ..utils.logging import get_logger
from .aggregation_worker import AggregationWorker


class GraphWorker(AggregationWorker):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._share_feature = self.config.algorithm_kwargs.get("share_feature", True)
        self._edge_drop_rate = self.config.algorithm_kwargs.get("edge_drop_rate", 0.0)
        self._send_parameter_diff = False
        self._own_nodes: np.ndarray | None = None
        self._other_training_node_indices: set[int] = set()
        self._boundary = np.zeros(0, np.int32)
        self._provide_nodes = np.zeros(0, np.int32)
        self._local_edge_mask: np.ndarray | None = None
        self._cross_edge_mask: np.ndarray | None = None
        #: the device copies the shared-feature step reads
        self._local_mask: torch.Tensor | None = None
        self._cross_mask: torch.Tensor | None = None
        self._provide_index: torch.Tensor | None = None
        self._received: tuple[bytes, torch.Tensor, torch.Tensor] | None = None
        self.communicated_bytes = 0
        self.skipped_bytes = 0
        self.exchange_count = 0
        # fed_aas resamples num_neighbor a round itself
        self._dataloader_num_neighbor = True

    def _aligned_stream(self) -> bool:
        return False

    # ------------------------------------------------------------- setup
    def _before_training(self) -> None:
        dc = self.trainer.dataset_collection
        dc.remove_dataset(phase=MachineLearningPhase.Test)
        dc.remove_dataset(phase=MachineLearningPhase.Validation)
        if self.config.distribute_init_parameters:
            try:
                self._get_result_from_server()
            except StopExecutingException:
                return
            if self._stopped():
                return
        self._exchange_training_node_indices()
        self._prune_edges()
        kwargs = self.config.algorithm_kwargs
        if "batch_number" in kwargs:
            self.trainer.update_dataloader_kwargs(batch_number=int(kwargs["batch_number"]))
        if self._dataloader_num_neighbor and "num_neighbor" in kwargs:
            self.trainer.update_dataloader_kwargs(num_neighbor=int(kwargs["num_neighbor"]))
        if self._share_feature:
            self.trainer.append_named_hook(
                ExecutorHookPoint.OPTIMIZER_STEP, "shared_feature_step", self._shared_feature_step
            )
        self._register_aggregation()

    @property
    def training_dataset(self):
        return self.trainer.dataset_collection.get_dataset(MachineLearningPhase.Training)

    def _exchange_training_node_indices(self) -> None:
        own_training = np.nonzero(self.training_dataset.inputs["mask"])[0].astype(np.int32)
        self.send_data_to_server(Message(in_round=True, other_data={"training_node_indices": own_training.tolist()}))
        merged = self._get_data_from_server().other_data["training_node_indices"]
        self._own_nodes = own_training
        others: set[int] = set()
        for worker_id, indices in merged.items():
            if int(worker_id) != self.worker_id:
                others.update(int(i) for i in indices)
        assert not others.intersection(own_training.tolist())
        self._other_training_node_indices = others

    def _prune_edges(self) -> None:
        graph = self.training_dataset.inputs
        src, dst = graph["edge_index"][0], graph["edge_index"][1]
        own = np.zeros(len(self.training_dataset.targets), bool)
        own[self._own_nodes] = True
        other_training = np.zeros_like(own)
        other_training[list(self._other_training_node_indices)] = True
        in_client = own[src] & own[dst]
        cross = (own[src] & other_training[dst]) | (other_training[src] & own[dst])
        if self._edge_drop_rate > 0:
            rng = np.random.default_rng(self.config.seed * 131 + self.worker_id)
            cross &= rng.random(cross.shape) >= self._edge_drop_rate
        self._local_edge_mask = in_client.astype(np.float32)
        self._cross_edge_mask = (in_client | cross).astype(np.float32)
        self._boundary = np.unique(
            np.concatenate([src[cross & other_training[src]], dst[cross & other_training[dst]]])
        ).astype(np.int32)
        self._provide_nodes = np.unique(np.concatenate([src[cross & own[src]], dst[cross & own[dst]]])).astype(
            np.int32
        )
        # the mask of the trainer's own (non-exchange) forward
        graph["edge_mask"] = self._cross_edge_mask if self._share_feature else self._local_edge_mask
        device = self.trainer.device
        self._local_mask = torch.from_numpy(self._local_edge_mask).to(device)
        self._cross_mask = torch.from_numpy(self._cross_edge_mask).to(device)
        self._provide_index = torch.from_numpy(self._provide_nodes.astype(np.int64)).to(device)
        get_logger().info(
            "%s: %d in-client edges, %d cross edges kept, boundary %d nodes",
            self.name, int(in_client.sum()), int(cross.sum()), len(self._boundary),
        )

    # ----------------------------------------------------- per-step exchange
    def _exchange_boundary_rows(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One exchange through the server for the stage output ``h``
        ``[N, H]``: the rows of the provided nodes out, the boundary's rows
        in.  Returns ``(h_received, received_mask)``, zero off the received
        rows."""
        payload = {
            "node_embedding": h.index_select(0, self._provide_index),
            "node_indices": self._provide_nodes,
            "boundary": self._boundary,
        }
        self.exchange_count += 1
        self.communicated_bytes += payload_nbytes(payload)
        self.send_data_to_server(Message(in_round=True, other_data=payload))
        result = self._get_data_from_server()
        received = result.other_data["node_embedding"]
        ids = np.asarray(result.other_data["node_indices"], np.int32)
        self.communicated_bytes += payload_nbytes(received)
        if self._received is None or self._received[0] != ids.tobytes():
            index = torch.from_numpy(ids.astype(np.int64)).to(h.device)
            mask = torch.zeros(h.shape[0], 1, dtype=h.dtype, device=h.device)
            mask[index] = 1.0
            self._received = (ids.tobytes(), index, mask)
        _, index, mask = self._received
        h_received = torch.zeros_like(h).index_copy_(0, index, received.to(h.dtype))
        return h_received, mask

    def _stage(self, views, i: int, h, inputs: dict, train: bool, generator=None) -> torch.Tensor:
        model_ctx = self.trainer.model_ctx
        with model_ctx.exclusive():
            module = model_ctx.module
            module.train(train)
            return torch.func.functional_call(
                module, model_ctx._cast_for_compute(views), (inputs,), {"stage": i, "h": h, "generator": generator}
            )

    def _shared_feature_step(self, executor, batch: dict, step_rng=None, **kwargs: Any) -> None:
        """One optimizer step with an exchange before every message-passing
        stage after the first: stage 0 over the in-client edges, the later
        stages over the in-client and kept cross edges (each capped by the
        batch's edge mask under ``num_neighbor``)."""
        trainer = executor
        num_layers = int(getattr(trainer.model_ctx.module, "num_mp_layers", 2))
        inputs = batch["input"]
        local_mask, cross_mask = self._local_mask, self._cross_mask
        if "edge_mask" in inputs:
            local_mask, cross_mask = local_mask * inputs["edge_mask"], cross_mask * inputs["edge_mask"]
        inputs_local = {**inputs, "edge_mask": local_mask}
        inputs_cross = {**inputs, "edge_mask": cross_mask}
        received = []
        with torch.no_grad():
            views = trainer.params
            h = self._stage(views, 0, None, inputs_local, False)
            for i in range(1, num_layers):
                h_received, received_mask = self._exchange_boundary_rows(h)
                received.append((h_received, received_mask))
                if i < num_layers - 1:  # the last stage's output feeds no exchange
                    h = h * (1.0 - received_mask) + h_received * received_mask
                    h = self._stage(views, i, h, inputs_cross, False)
        leaf = trainer.vec.detach().requires_grad_(True)
        views = trainer.engine.layout.split(leaf)
        h = self._stage(views, 0, None, inputs_local, True, step_rng)
        for i in range(1, num_layers):
            h_received, received_mask = received[i - 1]
            h = h * (1.0 - received_mask) + h_received * received_mask
            h = self._stage(views, i, h, inputs_cross, True, step_rng)
        loss, _ = masked_ce_loss(h, batch["target"], batch["mask"])
        loss.backward()
        trainer.engine.optimizer.step(trainer.vec, leaf.grad, trainer.opt_state)

    # ------------------------------------------------------------ artifacts
    def _after_training(self) -> None:
        super()._after_training()
        stat = {
            "communicated_bytes": int(self.communicated_bytes),
            "skipped_bytes": int(self.skipped_bytes),
            "exchange_count": int(self.exchange_count),
            "boundary_size": int(len(self._boundary)),
            "edge_count": int(self._cross_edge_mask.sum() if self._cross_edge_mask is not None else 0),
            "node_count": int(len(self._own_nodes) if self._own_nodes is not None else 0),
        }
        with open(os.path.join(self.save_dir, "graph_worker_stat.json"), "wt", encoding="utf8") as f:
            json.dump(stat, f)
