"""Federated participants (the port's copy of the JAX package's
``practitioner.py``): a stable participant identity bound to a worker slot,
holding its partition through a shared sampler."""

from .config import DistributedTrainingConfig
from .data import DatasetCollection, create_dataset_collection
from .sampler import DatasetCollectionSampler, get_dataset_collection_sampler


class Practitioner:
    def __init__(self, practitioner_id: int) -> None:
        self.practitioner_id = practitioner_id
        self._worker_id: int | None = None
        self._samplers: dict[str, DatasetCollectionSampler] = {}

    @property
    def worker_id(self) -> int:
        if self._worker_id is None:
            raise RuntimeError(f"practitioner {self.practitioner_id} has no worker slot")
        return self._worker_id

    def set_worker_id(self, worker_id: int) -> None:
        self._worker_id = worker_id

    def set_sampler(self, dataset_name: str, sampler: DatasetCollectionSampler) -> None:
        self._samplers[dataset_name] = sampler

    def get_sampler(self, dataset_name: str) -> DatasetCollectionSampler:
        return self._samplers[dataset_name]


def create_practitioners(
    config: DistributedTrainingConfig, dc: DatasetCollection | None = None
) -> list[Practitioner]:
    """``worker_number`` practitioners sharing one sampler, in worker order
    (``dc``: the config's dataset collection, built here when not given)."""
    if dc is None:
        dc = create_dataset_collection(config)
    sampler = get_dataset_collection_sampler(
        config.dataset_sampling,
        dc,
        config.worker_number,
        seed=config.seed,
        **dict(config.dataset_sampling_kwargs),
    )
    practitioners = []
    for practitioner_id in range(config.worker_number):
        practitioner = Practitioner(practitioner_id)
        practitioner.set_sampler(config.dataset_name, sampler)
        practitioner.set_worker_id(practitioner_id)
        practitioners.append(practitioner)
    return practitioners
