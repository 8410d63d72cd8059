"""Neighbor sampling and node minibatches of the graph sessions (the port's
``ops/graph_sampling.py``).

The graph keeps a static edge list; sampling is an edge-mask transform:

* :func:`cap_fan_in` caps the active incoming edges of every destination
  at ``limit`` from a numpy ``Generator`` (a copy of the JAX package's,
  exact: fed_aas's per-round resample);
* :func:`cap_fan_in_torch` is the JAX ``cap_fan_in_jax`` in torch, over
  ``[..., E]`` masks at once: each active edge's uniform priority, a
  stable sort by (destination, priority), the first ``limit`` active edges
  of each destination kept;
* :func:`minibatch_assignment` deals a slot's training nodes, in the order
  of their uniforms, round-robin into ``batch_number`` batches.

The uniforms are arguments, drawn by a :class:`GraphRandom`: with the JAX
session's uniforms, both torch functions return the JAX functions' masks
and assignments exactly (the sorts are stable, as JAX's are).
"""

import numpy as np
import torch

from .quantization import CodecRandom


def cap_fan_in(base_mask: np.ndarray, dst: np.ndarray, limit: int, rng) -> np.ndarray:
    """Cap incoming fan-in per destination at ``limit``: a random
    permutation of the active edges, a stable sort by destination, and the
    edges ranked below ``limit`` within their destination kept."""
    candidates = rng.permutation(np.nonzero(base_mask)[0])
    keep = np.zeros_like(base_mask, dtype=bool)
    if len(candidates):
        d = dst[candidates]
        by_dst = np.argsort(d, kind="stable")
        sorted_d = d[by_dst]
        first_idx = np.r_[0, np.nonzero(np.diff(sorted_d))[0] + 1]
        group_id = np.cumsum(np.r_[0, (np.diff(sorted_d) != 0).astype(np.int64)])
        rank = np.arange(len(sorted_d)) - first_idx[group_id]
        keep[candidates[by_dst[rank < limit]]] = True
    return keep


def cap_fan_in_torch(edge_mask: torch.Tensor, dst: torch.Tensor, limit: int, priority: torch.Tensor) -> torch.Tensor:
    """The fan-in cap of ``[..., E]`` edge masks from ``[..., E]`` uniform
    priorities; a float mask of ``edge_mask``'s shape and dtype in which
    inactive edges never survive."""
    n_edges = edge_mask.shape[-1]
    active = edge_mask > 0
    # inactive edges sort last within their destination
    priority = torch.where(active, priority, torch.full_like(priority, 2.0))
    # (destination, priority) order: by priority, then stably by destination
    by_priority = torch.sort(priority, dim=-1, stable=True).indices
    by_dst = torch.sort(dst[by_priority], dim=-1, stable=True).indices
    order = torch.gather(by_priority, -1, by_dst)
    sorted_dst = dst[order].contiguous()
    first = torch.searchsorted(sorted_dst, sorted_dst, side="left")
    rank = torch.arange(n_edges, device=edge_mask.device) - first
    keep_sorted = (rank < limit) & (torch.gather(priority, -1, order) < 1.5)
    return torch.zeros_like(edge_mask).scatter_(-1, order, keep_sorted.to(edge_mask.dtype))


def minibatch_assignment(train_mask: torch.Tensor, batch_number: int, uniform: torch.Tensor) -> torch.Tensor:
    """``[..., N]`` int64 batch ids: the training nodes ranked by their
    uniforms (a stable sort) and dealt round-robin into ``batch_number``
    batches; other nodes get ``batch_number`` (never selected)."""
    n = train_mask.shape[-1]
    training = train_mask > 0
    r = torch.where(training, uniform, torch.full_like(uniform, float("inf")))
    order = torch.sort(r, dim=-1, stable=True).indices  # training nodes first
    ranks = torch.arange(n, device=train_mask.device).expand_as(order)
    pos = torch.empty_like(order).scatter_(-1, order, ranks)
    return torch.where(training, pos % batch_number, torch.full_like(pos, batch_number))


class GraphRandom(CodecRandom):
    """The graph sessions' random source: per (seed, round, epoch[, batch])
    the ``[S, N]`` assignment uniforms, the ``[S, E]`` fan-in priorities
    and the dropout uniforms of a training step, all slots at once.  These
    are the port's own draws (``torch.Generator``s on the session's device,
    seeded through ``numpy.random.SeedSequence``); a subclass may return
    other draws for the same requests, such as the JAX session's
    threefry uniforms.  A :class:`~.quantization.CodecRandom` too, so one
    source serves every session."""

    def assignment_uniform(self, seed: int, round_number: int, epoch: int, shape, device) -> torch.Tensor:
        """Epoch ``epoch``'s (from 0) minibatch uniforms ``[S, N]`` in round
        ``round_number`` (from 1)."""
        return self._uniform([seed, 7, round_number, epoch], shape, device)

    def priority_uniform(self, seed: int, round_number: int, epoch: int, batch: int, shape, device) -> torch.Tensor:
        """Batch ``batch``'s fan-in priorities ``[S, E]``."""
        return self._uniform([seed, 11, round_number, epoch, batch], shape, device)

    def stage_dropout_uniform(self, seed: int, round_number: int, epoch: int, batch: int, stage: int, shape, device):
        """The dropout uniforms before stage ``stage`` of batch ``batch``'s
        training forward (``shape`` holds the slot axis)."""
        return self._uniform([seed, 13, round_number, epoch, batch, stage], shape, device)
