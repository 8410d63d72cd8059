"""Dataset collections with phase splits, as host numpy arrays (the port's
copy of the JAX package's ``data/collection.py``: vision, text and graph
splits)."""

import dataclasses
from typing import Any

import numpy as np

from ..ml_type import MachineLearningPhase


@dataclasses.dataclass
class ArrayDataset:
    """One split: ``inputs`` (NHWC images for vision, ``[N, max_len]``
    int32 token ids for text, or for a graph the dict ``{"x", "edge_index",
    "mask"}`` of the whole graph with this phase's node mask) and
    ``targets``."""

    inputs: Any
    targets: np.ndarray

    def __len__(self) -> int:
        if isinstance(self.inputs, dict):
            # a graph split counts the nodes under its phase mask
            return int(self.inputs["mask"].sum())
        return int(len(self.targets))

    def subset(self, indices: np.ndarray) -> "ArrayDataset":
        if isinstance(self.inputs, dict):
            # a graph keeps its global shapes: the subset narrows the
            # phase mask to the given nodes
            mask = np.zeros_like(self.inputs["mask"])
            if len(indices):
                mask[indices[self.inputs["mask"][indices]]] = True
            return ArrayDataset(inputs={**self.inputs, "mask": mask}, targets=self.targets)
        return ArrayDataset(inputs=self.inputs[indices], targets=self.targets[indices])


@dataclasses.dataclass
class DatasetCollection:
    name: str
    datasets: dict[MachineLearningPhase, ArrayDataset]
    num_classes: int
    input_shape: tuple[int, ...]
    dataset_type: str = "vision"  # vision | text | graph
    #: text: ``vocab_size``, ``max_len``, ``pad_id`` (and ``tokenizer``);
    #: graph: ``num_nodes``, ``num_edges``
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    def get_dataset(self, phase: MachineLearningPhase) -> ArrayDataset:
        return self.datasets[phase]

    def has_dataset(self, phase: MachineLearningPhase) -> bool:
        return phase in self.datasets

    def remove_dataset(self, phase: MachineLearningPhase) -> None:
        self.datasets.pop(phase, None)

    def dataset_size(self, phase: MachineLearningPhase) -> int:
        return len(self.datasets[phase])

    def subset(self, phase_indices: dict[MachineLearningPhase, np.ndarray]) -> "DatasetCollection":
        """A per-worker view holding only this worker's partition."""
        datasets = {
            phase: dataset.subset(phase_indices[phase]) if phase in phase_indices else dataset
            for phase, dataset in self.datasets.items()
        }
        return DatasetCollection(
            name=self.name,
            datasets=datasets,
            num_classes=self.num_classes,
            input_shape=self.input_shape,
            dataset_type=self.dataset_type,
            metadata=dict(self.metadata),
        )


def create_dataset_collection(config) -> DatasetCollection:
    from .registry import global_dataset_factory

    factory = global_dataset_factory.get(config.dataset_name)
    if factory is None:
        raise KeyError(
            f"unknown dataset {config.dataset_name!r}; known: {sorted(global_dataset_factory)}"
        )
    dc = factory(**dict(config.dataset_kwargs))
    if config.merge_validation_to_training_set and dc.has_dataset(
        MachineLearningPhase.Validation
    ):
        train = dc.get_dataset(MachineLearningPhase.Training)
        val = dc.get_dataset(MachineLearningPhase.Validation)
        if not isinstance(train.inputs, dict):  # a graph's splits stay apart
            dc.datasets[MachineLearningPhase.Training] = ArrayDataset(
                inputs=np.concatenate([train.inputs, val.inputs]),
                targets=np.concatenate([train.targets, val.targets]),
            )
            dc.remove_dataset(MachineLearningPhase.Validation)
    return dc
