from .base import (
    DatasetCollectionSampler,
    IIDSampler,
    get_dataset_collection_sampler,
    global_sampler_factory,
    permute_indices,
)

__all__ = [
    "DatasetCollectionSampler",
    "IIDSampler",
    "get_dataset_collection_sampler",
    "global_sampler_factory",
    "permute_indices",
]
