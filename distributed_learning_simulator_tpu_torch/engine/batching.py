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
