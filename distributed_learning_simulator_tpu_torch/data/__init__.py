from .collection import ArrayDataset, DatasetCollection, create_dataset_collection
from .registry import global_dataset_factory, register_dataset

__all__ = [
    "ArrayDataset",
    "DatasetCollection",
    "create_dataset_collection",
    "global_dataset_factory",
    "register_dataset",
]
