"""Dataset collections with phase splits, as host numpy arrays (the port's
copy of the JAX package's ``data/collection.py``: vision and text splits;
graph splits are not ported yet)."""

import dataclasses
from typing import Any

import numpy as np

from ..ml_type import MachineLearningPhase


@dataclasses.dataclass
class ArrayDataset:
    """One split: ``inputs`` (NHWC images for vision, ``[N, max_len]``
    int32 token ids for text) and ``targets``."""

    inputs: np.ndarray
    targets: np.ndarray

    def __len__(self) -> int:
        return int(len(self.targets))

    def subset(self, indices: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(inputs=self.inputs[indices], targets=self.targets[indices])


@dataclasses.dataclass
class DatasetCollection:
    name: str
    datasets: dict[MachineLearningPhase, ArrayDataset]
    num_classes: int
    input_shape: tuple[int, ...]
    dataset_type: str = "vision"  # vision | text
    #: text: ``vocab_size``, ``max_len``, ``pad_id`` (and ``tokenizer``)
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
        dc.datasets[MachineLearningPhase.Training] = ArrayDataset(
            inputs=np.concatenate([train.inputs, val.inputs]),
            targets=np.concatenate([train.targets, val.targets]),
        )
        dc.remove_dataset(MachineLearningPhase.Validation)
    return dc
