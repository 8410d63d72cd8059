"""Federated GNN rounds on one device (the port's ``parallel/spmd_gnn.py``:
fed_gnn and fed_gcn in :class:`SpmdFedGNNSession`, fed_aas in
:class:`SpmdFedAASSession`).

Every worker owns one subgraph of a single static graph (the sampler's
node split).  The JAX session trains all client slots in lockstep under
``vmap``: before every message-passing stage after the first, the slots
exchange the boundary embeddings they provide through one global table,
so no slot can take its step before every slot's stage-0 output exists.
Here the slots are a leading axis of the models themselves:

* the parameters are one ``[S, D]`` matrix (rows on 128-byte boundaries)
  with ONE optimizer state a round (trace 0, count 0), and the engine's
  SGD steps all rows at once;
* a training step runs the graph model once through ``functional_call``
  on ``[S, ...]`` parameter views with ``[S, E]`` edge masks
  (``models/graph.py``): stage 0 over each slot's in-client edges, each
  later stage over its in-client and surviving cross edges;
* under ``share_feature`` the table before stage ``i`` is
  ``einsum("sn,snh->nh", provide, h)`` of the previous stage's output,
  detached (the JAX ``stop_gradient``), and each slot reads the rows it
  receives from it: ``h * (1 - recv) + table * recv``.  Stage 0 has no
  dropout in any model, so its training output is the exchanged one; the
  later stages of the exchange (ThreeGCN's) run again without dropout;
* the loss is the sum of the slots' masked losses (``vmap`` of
  :func:`~..models.registry.masked_ce_loss`): each slot's gradient is that
  of its own loss, and every slot steps every batch, also one whose batch
  holds no training node (the engine's ``train_step`` would skip it);
* with ``batch_number > 1`` or a data-loader ``num_neighbor`` (fed_gnn and
  fed_gcn), each epoch deals every slot's training nodes into
  ``batch_number`` batches (``ops/graph_sampling.py::minibatch_assignment``)
  and, under ``num_neighbor``, caps each batch's cross-edge fan-in
  (``cap_fan_in_torch``: ``local *= keep``, ``cross = keep``);
* the aggregate is kernel K1 over the ``[S, D]`` f32 rows with the dataset
  sizes as weights, divided by ``max(sum, 1e-12)``: one launch a round.

The random numbers (assignment uniforms, fan-in priorities, dropout) come
from a :class:`~..ops.graph_sampling.GraphRandom`, the ``random`` entry of
``endpoint_kwargs.worker`` (default: the port's own draws), so a test can
hand in the JAX session's.  ``edge_drop_rate`` and fed_aas's per-round
fan-in resample are the JAX package's numpy streams, exact.  As in the
JAX session, every node a worker owns trains, its test nodes included
(``ROADMAP.md`` R13).

Each round queues ``aggregated_model/round_N.npz`` (JAX keys, through the
checkpoint writer: one device-to-host copy of the f32 master, written
while the evaluation runs), writes a row of ``server/round_record.json``
atomically (the test metrics, ``received_mb`` / ``sent_mb`` of the
boundary exchange, ``round_seconds``) and, on an improvement, promotes the
round's checkpoint to ``server/best_global_model.npz`` by a file copy.
``resume_dir`` restores the newest resumable round and its record rows
(``util/resume.py``) and runs on from the next; every draw is keyed by
the round, so nothing is replayed.  As in the JAX session, the fault plan's
kill is ignored, and ``watchdog_seconds`` guards the round and the
evaluation.
"""

import os
import time

import numpy as np
import torch

from ..engine.batching import make_graph_batch
from ..engine.engine import maybe_slow_metrics, summarize_metrics
from ..ml_type import MachineLearningPhase as Phase
from ..models.convert import from_jax, jax_leaves
from ..models.registry import masked_ce_loss
from ..ops.graph_sampling import GraphRandom, cap_fan_in, cap_fan_in_torch, minibatch_assignment
from ..ops.pytree import flat_stack_weighted_sum
from ..util.checkpoint import AsyncCheckpointWriter, atomic_json_dump, jax_views
from ..util.resume import load_resume_state
from ..utils.logging import get_logger
from .watchdog import DeadlineWatchdog

#: algorithm_kwargs the graph sessions read; any other key raises
SUPPORTED_ALGORITHM_KWARGS = frozenset(
    {"share_feature", "batch_number", "edge_drop_rate", "num_neighbor", "resume_dir"}
)
#: the round machinery's knobs, which the JAX graph sessions read nowhere
_JAX_IGNORES = frozenset({"min_client_quorum", "aggregation_mode", "buffer_size", "staleness_alpha"})


class SpmdFedGNNSession:
    """fed_gnn / fed_gcn: the slots in lockstep with the boundary exchange
    (without ``share_feature``: each on its own subgraph)."""

    supported_algorithm_kwargs = SUPPORTED_ALGORITHM_KWARGS
    #: fed_gnn caps fan-in per minibatch; fed_aas resamples per round
    _dataloader_num_neighbor = True

    def __init__(self, config, dataset_collection, model_ctx, engine, practitioners, share_feature=None) -> None:
        kwargs = config.algorithm_kwargs
        unsupported = sorted(set(kwargs) - self.supported_algorithm_kwargs)
        ignored = [k for k in unsupported if k in _JAX_IGNORES]
        if ignored:
            raise NotImplementedError(
                f"algorithm_kwargs {ignored}: the JAX graph sessions take them and ignore them, and the port"
                " refuses them (ROADMAP.md R18)"
            )
        if unsupported:
            raise NotImplementedError(
                f"algorithm_kwargs {unsupported} are not ported yet on the graph sessions"
                " (ROADMAP.md Queue 1 item 7)"
            )
        self.config = config
        self.practitioners = practitioners
        self.model_ctx = model_ctx
        self.engine = engine
        self.device = model_ctx.device
        self.n_slots = config.worker_number
        self.share_feature = bool(kwargs.get("share_feature", True) if share_feature is None else share_feature)
        self.batch_number = int(kwargs.get("batch_number") or 1)
        self.num_neighbor = kwargs.get("num_neighbor") if self._dataloader_num_neighbor else None
        self.num_layers = int(model_ctx.module.num_mp_layers)
        random = config.endpoint_kwargs.get("worker", {}).get("random")
        self._random = GraphRandom() if random is None else random
        if not isinstance(self._random, GraphRandom):
            raise TypeError(f"the graph sessions draw from a GraphRandom, not {type(self._random).__name__}")
        self._stat: dict[int, dict] = {}
        self._max_acc = 0.0
        self._ckpt = AsyncCheckpointWriter()
        self._watchdog = DeadlineWatchdog.from_config(config, self.device)
        self._prepare_data(dataset_collection, practitioners)
        self._weights = torch.from_numpy(self._dataset_sizes).to(self.device)
        test = make_graph_batch(dataset_collection.get_dataset(Phase.Test))
        self._test_batch = {
            "input": self._graph,
            "target": self._targets,
            "mask": torch.from_numpy(test["mask"]).to(self.device),
        }

    # ------------------------------------------------------------------
    def _prepare_data(self, dataset_collection, practitioners) -> None:
        """The per-slot masks, the dataset sizes and the exchange's bytes,
        in the JAX ``_prepare_data``'s order and streams."""
        config = self.config
        train = dataset_collection.get_dataset(Phase.Training)
        graph = train.inputs
        num_nodes = len(train.targets)
        edge_index = np.asarray(graph["edge_index"])
        src, dst = edge_index[0], edge_index[1]
        drop_rate = float(config.algorithm_kwargs.get("edge_drop_rate", 0.0))
        own_lists = []
        for practitioner in sorted(practitioners, key=lambda p: p.worker_id):
            idx = practitioner.get_sampler(config.dataset_name).sample(practitioner.practitioner_id)[Phase.Training]
            own_lists.append(np.asarray(idx, np.int64))

        S = self.n_slots
        local_edges = np.zeros((S, src.shape[0]), np.float32)
        cross_edges = np.zeros_like(local_edges)
        provide_mask = np.zeros((S, num_nodes), np.float32)
        boundary_mask = np.zeros_like(provide_mask)
        train_mask = np.zeros_like(provide_mask)
        sizes = np.zeros(S, np.float32)
        all_training = np.zeros(num_nodes, bool)
        for idx in own_lists:
            all_training[idx] = True
        for c, idx in enumerate(own_lists):
            own = np.zeros(num_nodes, bool)
            own[idx] = True
            other_training = all_training & ~own
            in_client = own[src] & own[dst]
            cross = (own[src] & other_training[dst]) | (other_training[src] & own[dst])
            if drop_rate > 0:
                rng = np.random.default_rng(config.seed * 131 + c)
                cross &= rng.random(cross.shape) >= drop_rate
            local_edges[c] = in_client
            cross_edges[c] = in_client | cross
            prov = np.unique(np.concatenate([src[cross & own[src]], dst[cross & own[dst]]]))
            bnd = np.unique(np.concatenate([src[cross & other_training[src]], dst[cross & other_training[dst]]]))
            provide_mask[c, prov.astype(np.int64)] = 1.0
            boundary_mask[c, bnd.astype(np.int64)] = 1.0
            train_mask[c, own] = 1.0  # every owned node trains (R13)
            sizes[c] = len(idx)
        # a slot only receives rows someone provides
        recv_mask = boundary_mask * provide_mask.max(axis=0)[None, :]

        self._dataset_sizes = sizes
        hidden = int(getattr(self.model_ctx.module, "hidden", 64))
        boundaries = self.num_layers - 1
        # one exchange set a minibatch an epoch, in the JAX package's f32
        # arithmetic
        steps = config.epoch * self.batch_number
        self._round_payload_bytes = int(steps * boundaries * 4 * hidden * (provide_mask.sum() + recv_mask.sum()))
        if not self.share_feature:
            cross_edges = local_edges.copy()
            recv_mask = np.zeros_like(recv_mask)
            self._round_payload_bytes = 0

        self._host_local = local_edges
        self._dst_host = dst.copy()
        # the per-slot masks the round reads, [S, E] and [S, N] f32
        host = {"local_edges": local_edges, "cross_edges": cross_edges, "provide": provide_mask, "recv": recv_mask,
                "train_mask": train_mask}
        self._masks = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        edges = torch.from_numpy(edge_index.astype(np.int64)).to(self.device)
        self._graph = {"x": torch.from_numpy(np.asarray(graph["x"], np.float32)).to(self.device), "edge_index": edges}
        self._dst = edges[1]
        self._targets = torch.from_numpy(np.asarray(train.targets, np.int64)).to(self.device)

    # ------------------------------------------------------------------
    def _stage(self, views, i: int, h, edge_mask, train: bool, draw=None) -> torch.Tensor:
        module = self.model_ctx.module
        module.train(train)
        inputs = {**self._graph, "edge_mask": edge_mask}
        return torch.func.functional_call(module, views, (inputs,), {"stage": i, "h": h, "draw": draw})

    def _tables(self, views, h0: torch.Tensor, cross_m: torch.Tensor) -> list[torch.Tensor]:
        """The exchange before each stage after the first: the provided rows
        summed over the slots into one ``[N, H]`` table, detached."""
        provide, recv = self._masks["provide"], self._masks["recv"][..., None]
        tables, h = [], h0
        with torch.no_grad():
            for i in range(1, self.num_layers):
                table = torch.einsum("sn,snh->nh", provide, h)
                tables.append(table)
                if i < self.num_layers - 1:
                    h = self._stage(views, i, h * (1.0 - recv) + table[None] * recv, cross_m, False)
        return tables

    def train_step(self, params, opt_state, local_m, cross_m, train_m, draw) -> None:
        """One lockstep step of every slot on ``params`` ``[S, D]`` in place:
        the exchange, each slot's masked loss and gradient, one SGD step."""
        leaf = params.detach().requires_grad_(True)
        views = self.engine.layout.split(leaf)  # [S, *shape] each
        h = self._stage(views, 0, None, local_m, True, draw)
        tables = self._tables(views, h.detach(), cross_m) if self.share_feature else None
        recv = self._masks["recv"][..., None]
        for i in range(1, self.num_layers):
            if tables is not None:
                h = h * (1.0 - recv) + tables[i - 1] * recv
            h = self._stage(views, i, h, cross_m, True, draw)
        losses = torch.func.vmap(masked_ce_loss, in_dims=(0, None, 0))(h, self._targets, train_m)[0]
        losses.sum().backward()
        self.engine.optimizer.step(params, leaf.grad, opt_state)

    def _draw(self, round_number: int, epoch: int, batch: int):
        def draw(stage, shape):
            return self._random.stage_dropout_uniform(
                self.config.seed, round_number, epoch, batch, stage, shape, self.device
            )

        return draw

    def run_round(self, global_vec: torch.Tensor, round_number: int) -> torch.Tensor:
        """One round from the f32 master: every slot's local epochs in
        lockstep, then K1; returns the new master."""
        S, D = self.n_slots, global_vec.numel()
        row_stride = -(-D // 64) * 64  # rows on 128-byte boundaries for K1
        params = torch.empty(S, row_stride, device=self.device)[:, :D]
        params.copy_(global_vec)
        opt_state = self.engine.init_opt_state(params)
        masks, seed = self._masks, self.config.seed
        minibatched = self.batch_number > 1 or self.num_neighbor is not None
        for epoch in range(self.config.epoch):
            if not minibatched:
                self.train_step(
                    params, opt_state, masks["local_edges"], masks["cross_edges"], masks["train_mask"],
                    self._draw(round_number, epoch, 0),
                )
                continue
            uniform = self._random.assignment_uniform(seed, round_number, epoch, tuple(masks["train_mask"].shape), self.device)
            assign = minibatch_assignment(masks["train_mask"], self.batch_number, uniform)
            for b in range(self.batch_number):
                train_b = masks["train_mask"] * (assign == b)
                local_m, cross_m = masks["local_edges"], masks["cross_edges"]
                if self.num_neighbor is not None:
                    priority = self._random.priority_uniform(seed, round_number, epoch, b, tuple(cross_m.shape), self.device)
                    keep = cap_fan_in_torch(cross_m, self._dst, int(self.num_neighbor), priority)
                    local_m, cross_m = local_m * keep, keep
                self.train_step(params, opt_state, local_m, cross_m, train_b, self._draw(round_number, epoch, b))
        total = flat_stack_weighted_sum(params, self._weights)
        return total / max(float(self._dataset_sizes.sum()), 1e-12)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _evaluate(self, global_vec: torch.Tensor) -> dict:
        """The test metrics on the whole graph (no edge mask)."""
        params = self.engine.layout.split(global_vec)
        _, aux = self.model_ctx.loss(params, self._test_batch)
        metric = summarize_metrics({"loss_sum": aux["loss_sum"].sum(), "correct": aux["correct"], "count": aux["count"]})
        stacked = {
            "input": {k: v[None] for k, v in self._test_batch["input"].items()},
            "target": self._test_batch["target"][None],
            "mask": self._test_batch["mask"][None],
        }
        metric.update(maybe_slow_metrics(self.config, self.engine, params, stacked))
        return metric

    def _before_round(self, round_number: int) -> None:
        """Per-round changes to the masks (fed_aas's resample)."""

    def _start(self) -> tuple[torch.Tensor, int]:
        """The f32 master and the first round: the newest resumable round of
        ``resume_dir`` (its record rows restored), else a fresh init."""
        resume_dir = self.config.algorithm_kwargs.get("resume_dir")
        if resume_dir:
            params, stats, last = load_resume_state(resume_dir)
            if params is not None:
                self._stat = stats
                self._max_acc = max((s.get("test_accuracy", 0.0) for s in stats.values()), default=0.0)
                get_logger().info("resumed graph session from %s round %d", resume_dir, last)
                return self._flat(from_jax(params)), last + 1
            get_logger().warning("nothing resumable under %s; starting fresh", resume_dir)
        return self._flat(self.engine.init_params(self.config.seed)), 1

    def _flat(self, params: dict) -> torch.Tensor:
        return self.engine.layout.flatten({k: v.to(self.device, torch.float32) for k, v in params.items()})

    def run(self) -> dict:
        config = self.config
        save_dir = os.path.join(config.save_dir, "server")
        model_dir = os.path.join(config.save_dir, "aggregated_model")
        os.makedirs(save_dir, exist_ok=True)
        os.makedirs(model_dir, exist_ok=True)
        global_vec, start_round = self._start()
        leaves = jax_leaves(self.engine.layout.keys, self.engine.layout.shapes)
        mb = self._round_payload_bytes / 1e6
        with self._ckpt:  # drains the writes at exit, errors included
            for round_number in range(start_round, config.round + 1):
                start = time.monotonic()
                self._before_round(round_number)
                global_vec = self._watchdog.call(
                    lambda g=global_vec, r=round_number: self.run_round(g, r), phase="round", round_number=round_number
                )
                # queued now, so the copy and the write overlap the evaluation
                self._ckpt.save_rows(
                    os.path.join(model_dir, f"round_{round_number}.npz"),
                    [global_vec],
                    lambda host: jax_views(host[0], leaves),
                )
                metric = self._watchdog.call(
                    lambda g=global_vec: self._evaluate(g), phase="eval", round_number=round_number
                )
                row = {f"test_{k}": v for k, v in metric.items()}
                row.update({"received_mb": mb, "sent_mb": mb, "round_seconds": time.monotonic() - start})
                self._stat[round_number] = row
                get_logger().info(
                    "round: %d, test accuracy %.4f loss %.4f (torch gnn, %.3f MB exchanged)",
                    round_number, metric["accuracy"], metric["loss"], mb,
                )
                atomic_json_dump(os.path.join(save_dir, "round_record.json"), self._stat)
                if metric["accuracy"] > self._max_acc:
                    self._max_acc = metric["accuracy"]
                    self._ckpt.copy_last_to(os.path.join(save_dir, "best_global_model.npz"))
        return {"performance": self._stat}


class SpmdFedAASSession(SpmdFedGNNSession):
    """fed_aas: local-subgraph training with no exchange, the fan-in capped
    on the host every round from ``default_rng(seed * 1013 + c * 97 +
    round)`` when ``num_neighbor`` is set (``algorithm_kwargs``, else
    ``extra_hyper_parameters``)."""

    _dataloader_num_neighbor = False

    def __init__(self, config, *args) -> None:
        super().__init__(config, *args, share_feature=False)
        self._num_neighbor = config.algorithm_kwargs.get(
            "num_neighbor", config.extra_hyper_parameters.get("num_neighbor")
        )
        self._base_local = self._host_local.astype(bool)

    def _before_round(self, round_number: int) -> None:
        if self._num_neighbor is None:
            return
        limit = int(self._num_neighbor)
        resampled = np.zeros(self._base_local.shape, np.float32)
        for c in range(self._base_local.shape[0]):
            rng = np.random.default_rng(self.config.seed * 1013 + c * 97 + round_number)
            resampled[c] = cap_fan_in(self._base_local[c], self._dst_host, limit, rng)
        masks = torch.from_numpy(resampled).to(self.device)
        self._masks["local_edges"] = self._masks["cross_edges"] = masks
