"""Dataset partitioning over federated participants (the port's copy of the
JAX package's ``sampler/base.py``: the iid split of vision, text and graph
datasets).  A graph is split once, over all its nodes, and every phase
shares that node partition.

The iid split permutes each class with the repo's xorshift64 Fisher-Yates
stream (``native/fastops.cc::permute_indices``), written out here in
Python, so the partitions are byte-equal to the JAX package's.
"""

from collections.abc import Callable

import numpy as np

from ..data.collection import DatasetCollection
from ..ml_type import MachineLearningPhase as Phase

global_sampler_factory: dict[str, Callable[..., "DatasetCollectionSampler"]] = {}

_MASK64 = (1 << 64) - 1


def register_sampler(name: str):
    def deco(cls):
        global_sampler_factory[name.lower()] = cls
        return cls

    return deco


def _xorshift64(state: int) -> int:
    state ^= (state << 13) & _MASK64
    state ^= state >> 7
    state ^= (state << 17) & _MASK64
    return state


def permute_indices(n: int, seed: int) -> np.ndarray:
    """Permutation of ``arange(n)``: in-place Fisher-Yates driven by a
    xorshift64 stream, identical on every platform."""
    idx = np.arange(n, dtype=np.int64)
    state = ((seed & _MASK64) * 0x9E3779B97F4A7C15 + 1) & _MASK64
    for _ in range(4):  # warm up the stream
        state = _xorshift64(state)
    for i in range(n - 1, 0, -1):
        state = _xorshift64(state)
        j = state % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return idx


class DatasetCollectionSampler:
    """Base: computes per-part index arrays for every phase once."""

    def __init__(
        self,
        dataset_collection: DatasetCollection,
        part_number: int,
        seed: int = 0,
        **kwargs,
    ) -> None:
        if dataset_collection.dataset_type not in ("vision", "text", "graph"):
            raise NotImplementedError(
                f"{dataset_collection.dataset_type} partitions are not ported yet"
            )
        self.dataset_collection = dataset_collection
        self.part_number = part_number
        self.seed = seed
        self._parts: dict[int, dict[Phase, np.ndarray]] = {i: {} for i in range(part_number)}
        if dataset_collection.dataset_type == "graph":
            # one label-stratified split of ALL nodes, with the Training
            # salt, shared by every phase: a worker owns one subgraph
            dataset = next(iter(dataset_collection.datasets.values()))
            split = self._split_indices(np.arange(len(dataset.targets)), dataset.targets, Phase.Training)
            for i, idx in enumerate(split):
                for phase in dataset_collection.datasets:
                    self._parts[i][phase] = np.sort(idx)
            return
        for phase in list(dataset_collection.datasets):
            dataset = dataset_collection.get_dataset(phase)
            split = self._split_indices(np.arange(len(dataset)), dataset.targets, phase)
            for i, idx in enumerate(split):
                self._parts[i][phase] = np.sort(idx)

    def _split_indices(
        self, indices: np.ndarray, targets: np.ndarray, phase: Phase
    ) -> list[np.ndarray]:
        raise NotImplementedError

    def sample(self, part_id: int) -> dict[Phase, np.ndarray]:
        return self._parts[part_id]


def _phase_salt(phase: Phase) -> int:
    return list(Phase).index(phase) + 1


@register_sampler("iid")
class IIDSampler(DatasetCollectionSampler):
    """Per-class proportional split: each part receives an equal share of
    every class."""

    def _split_indices(self, indices, targets, phase):
        parts: list[list[np.ndarray]] = [[] for _ in range(self.part_number)]
        for label in np.unique(targets):
            label_idx = indices[targets == label]
            perm = permute_indices(
                len(label_idx),
                seed=self.seed * 1009 + _phase_salt(phase) * 131 + int(label),
            )
            label_idx = label_idx[perm]
            for i, chunk in enumerate(np.array_split(label_idx, self.part_number)):
                parts[i].append(chunk)
        return [np.concatenate(p) if p else np.array([], dtype=np.int64) for p in parts]


def get_dataset_collection_sampler(
    name: str, dataset_collection: DatasetCollection, part_number: int, **kwargs
) -> DatasetCollectionSampler:
    cls = global_sampler_factory.get(name.lower())
    if cls is None:
        raise NotImplementedError(
            f"sampler {name!r} is not ported yet; ported: {sorted(global_sampler_factory)}"
        )
    return cls(dataset_collection, part_number, **kwargs)
