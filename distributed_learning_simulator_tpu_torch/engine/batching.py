"""Static-shape batching (the port's copy of the JAX package's
``engine/batching.py``).

Datasets whose size is not a multiple of the batch size are padded with
zero-weight samples (``mask``) instead of a ragged final batch, so every
client slot and every evaluation batch has one shape.  Rows are gathered
with numpy fancy indexing, which gives the same bytes as the JAX package's
native gather.
"""

import numpy as np
import torch

from ..data.collection import ArrayDataset


def make_epoch_batches(
    dataset: ArrayDataset, batch_size: int, rng: np.random.Generator | None = None
) -> dict:
    """``{"input": [n, B, ...], "target": [n, B], "mask": [n, B]}`` in
    dataset order, or in the order ``rng.permutation`` draws (the threaded
    trainer's per-epoch shuffle: the same rng gives the JAX package's
    batches, byte for byte)."""
    n = len(dataset)
    if n <= 0:
        raise ValueError("empty dataset")
    order = np.arange(n)
    if rng is not None:
        order = rng.permutation(order)
    n_batches = max(1, (n + batch_size - 1) // batch_size)
    pad = n_batches * batch_size - n
    order = np.concatenate([order, np.zeros(pad, dtype=order.dtype)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return {
        "input": dataset.inputs[order].reshape(
            n_batches, batch_size, *dataset.inputs.shape[1:]
        ),
        "target": dataset.targets[order].reshape(n_batches, batch_size),
        "mask": mask.reshape(n_batches, batch_size),
    }


def make_graph_batch(dataset: ArrayDataset) -> dict:
    """A graph split as one batch: the whole graph (``{"x", "edge_index"}``)
    with the phase mask as the sample weights."""
    graph = dataset.inputs
    return {
        "input": {k: v for k, v in graph.items() if k != "mask"},
        "target": dataset.targets,
        "mask": graph["mask"].astype(np.float32),
    }


def make_graph_minibatches(
    batch: dict, batch_number: int, num_neighbor: int | None, rng: np.random.Generator
) -> dict:
    """A full-graph batch as ``batch_number`` minibatches of its training
    nodes (the JAX package's graph data loader): the nodes in the order
    ``rng.permutation`` draws, dealt round-robin, every batch the same graph
    with its own loss ``mask``, and under ``num_neighbor`` its own
    fan-in-capped ``edge_mask`` (``cap_fan_in`` from the same ``rng``, batch
    by batch, after the permutation).  Always ``batch_number`` batches,
    empty ones included: the boundary exchange is a barrier of every worker
    a batch.  Leaves that do not change between batches are
    ``np.broadcast_to`` views (``strides[0] == 0``)."""
    from ..ops.graph_sampling import cap_fan_in

    mask = np.asarray(batch["mask"])
    order = rng.permutation(np.nonzero(mask)[0])
    n_batches = max(1, int(batch_number))
    masks = np.zeros((n_batches, mask.shape[0]), np.float32)
    for b in range(n_batches):
        masks[b, order[b::n_batches]] = 1.0
    batch_inputs = dict(batch["input"])
    if num_neighbor is not None and "edge_mask" not in batch_inputs:
        batch_inputs["edge_mask"] = np.ones(np.asarray(batch_inputs["edge_index"]).shape[1], np.float32)
    inputs = {}
    for key, value in batch_inputs.items():
        value = np.asarray(value)
        if key == "edge_mask" and num_neighbor is not None:
            dst = np.asarray(batch["input"]["edge_index"])[1]
            capped = np.zeros((n_batches, value.shape[0]), value.dtype)
            for b in range(n_batches):
                capped[b] = cap_fan_in(value.astype(bool), dst, int(num_neighbor), rng)
            inputs[key] = capped
        else:
            inputs[key] = np.broadcast_to(value[None], (n_batches, *value.shape))
    target = np.asarray(batch["target"])
    return {"input": inputs, "target": np.broadcast_to(target[None], (n_batches, *target.shape)), "mask": masks}


def select_batch(batches: dict, index) -> dict:
    """Batch ``index`` (an int, or a slice for a stack of batches) of stacked
    batches; a graph's input dict is indexed leaf by leaf."""
    return {
        k: {name: leaf[index] for name, leaf in v.items()} if isinstance(v, dict) else v[index]
        for k, v in batches.items()
    }


def fixed_size_partition(indices: np.ndarray, size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad or truncate an index set to exactly ``size``: ``(indices, mask)``."""
    n = len(indices)
    if n >= size:
        return indices[:size], np.ones(size, np.float32)
    pad = np.zeros(size - n, dtype=indices.dtype if n else np.int64)
    if n:
        pad = np.full(size - n, indices[0], dtype=indices.dtype)
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(size - n, np.float32)])
    return np.concatenate([indices, pad]), mask


def stage_batches(batches: dict, compute_dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """Host batches on the device: floating inputs stored in the compute
    dtype once (the JAX session's hoisted cast), integer inputs (token
    ids) as int64, which no cast may touch (bf16 holds integers exactly
    only up to 256), targets as int64, the mask as f32."""
    inputs = torch.from_numpy(np.ascontiguousarray(batches["input"]))
    dtype = compute_dtype if inputs.is_floating_point() else torch.int64
    return {
        "input": inputs.to(device, dtype),
        "target": torch.from_numpy(np.ascontiguousarray(batches["target"])).to(device, torch.int64),
        "mask": torch.from_numpy(np.ascontiguousarray(batches["mask"])).to(device, torch.float32),
    }


def host_tensor(array: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``array``: its memory where it is contiguous and
    writable, else a copy (a broadcast view is neither)."""
    if array.flags.writeable:
        return torch.from_numpy(np.ascontiguousarray(array))
    return torch.from_numpy(np.array(array))


def stage_graph_batches(host: dict, compute_dtype: torch.dtype, device) -> dict:
    """Host graph batches (``make_graph_minibatches``'s layout, or one batch)
    on the device: a leaf that is the same in every batch is staged once
    and expanded (a view, no copy) along the batch axis; the masks are
    staged whole.  Features in the compute dtype, edges and labels as
    int64, masks as f32."""
    n = host["mask"].shape[0]

    def put(leaf: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        if n == 1 or leaf.strides[0] == 0:
            staged = host_tensor(leaf[0]).to(device, dtype)
            return staged.unsqueeze(0).expand(n, *staged.shape)
        return host_tensor(leaf).to(device, dtype)

    inputs = {}
    for name, leaf in host["input"].items():
        leaf = np.asarray(leaf)
        if name == "edge_index":
            dtype = torch.int64
        elif name == "edge_mask":
            dtype = torch.float32
        else:
            dtype = compute_dtype if np.issubdtype(leaf.dtype, np.floating) else torch.int64
        inputs[name] = put(leaf, dtype)
    return {
        "input": inputs,
        "target": put(np.asarray(host["target"]), torch.int64),
        "mask": torch.from_numpy(np.ascontiguousarray(host["mask"], np.float32)).to(device),
    }
