"""Dataset registry with the deterministic synthetic generators.

The port's copy of the JAX package's ``data/registry.py``: class-prototype
images plus scale jitter and gaussian noise, class-dependent unigram token
streams, and stochastic-block-model graphs with class-prototype node
features, all from numpy ``default_rng`` seeded by the dataset's name, so
the arrays are byte-equal to the JAX package's.  The graph names are the
JAX registry's ten and no more (``Yelp``, which ``conf/fed_aas/yelp.yaml``
names, is not among them, and raises the same ``KeyError`` there as in
the JAX package).  Real data on disk (``$DLS_TPU_DATA_DIR/<name>.npz``)
is not ported yet and raises rather than give different data.
"""

import hashlib
import os
from collections.abc import Callable

import numpy as np

from ..ml_type import MachineLearningPhase as Phase
from .collection import ArrayDataset, DatasetCollection

global_dataset_factory: dict[str, Callable[..., DatasetCollection]] = {}


def register_dataset(name: str):
    def deco(fn):
        global_dataset_factory[name] = fn
        return fn

    return deco


def _seed_for(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def _refuse_real_data(name: str) -> None:
    data_dir = os.environ.get("DLS_TPU_DATA_DIR", "")
    if data_dir and os.path.isfile(os.path.join(data_dir, f"{name}.npz")):
        raise NotImplementedError(
            f"real data for {name!r} under DLS_TPU_DATA_DIR is not ported yet"
            " (ROADMAP.md, port: real-data loader); unset DLS_TPU_DATA_DIR"
            " to use the synthetic generator"
        )


def _synthetic_vision(
    name: str,
    shape: tuple[int, ...],
    num_classes: int,
    train_size: int,
    val_size: int,
    test_size: int,
    noise: float = 0.35,
) -> DatasetCollection:
    """Class-prototype images + scale jitter + gaussian noise: linearly
    learnable, deterministic in the dataset name."""
    rng = np.random.default_rng(_seed_for(name))
    prototypes = rng.normal(0.0, 1.0, size=(num_classes, *shape)).astype(np.float32)

    def make(n: int, split_salt: int) -> ArrayDataset:
        r = np.random.default_rng(_seed_for(name) + split_salt)
        labels = r.integers(0, num_classes, size=n).astype(np.int32)
        scale = r.uniform(0.6, 1.4, size=(n,) + (1,) * len(shape)).astype(np.float32)
        x = prototypes[labels] * scale + r.normal(0, noise, size=(n, *shape)).astype(np.float32)
        return ArrayDataset(x.astype(np.float32), labels)

    return DatasetCollection(
        name=name,
        datasets={
            Phase.Training: make(train_size, 1),
            Phase.Validation: make(val_size, 2),
            Phase.Test: make(test_size, 3),
        },
        num_classes=num_classes,
        input_shape=shape,
        dataset_type="vision",
    )


def _vision_factory(name: str, shape: tuple[int, ...], num_classes: int, default_train: int):
    @register_dataset(name)
    def factory(
        train_size: int = default_train,
        val_size: int = 0,
        test_size: int = 0,
        **_: object,
    ) -> DatasetCollection:
        _refuse_real_data(name)
        val_size_ = val_size or max(256, train_size // 8)
        test_size_ = test_size or max(512, train_size // 4)
        return _synthetic_vision(name, shape, num_classes, train_size, val_size_, test_size_)

    return factory


# shapes and class counts of the real datasets named in conf/**
_vision_factory("MNIST", (28, 28, 1), 10, 4096)
_vision_factory("FashionMNIST", (28, 28, 1), 10, 4096)
_vision_factory("CIFAR10", (32, 32, 3), 10, 4096)
_vision_factory("CIFAR100", (32, 32, 3), 100, 8192)
_vision_factory("IMAGENET", (64, 64, 3), 100, 8192)


def _synthetic_text(
    name: str,
    num_classes: int,
    vocab_size: int,
    max_len: int,
    train_size: int,
    val_size: int,
    test_size: int,
) -> DatasetCollection:
    """Class-dependent unigram token distributions over a shared vocab;
    pad = 0.  The numpy calls are the JAX package's, in its order, so the
    token arrays are byte-equal."""
    seed = _seed_for(name)
    rng = np.random.default_rng(seed)
    # each class boosts a random subset of "topic" tokens
    logits = rng.normal(0, 1.0, size=(num_classes, vocab_size)).astype(np.float64)
    logits[:, 0] = -np.inf  # pad token never sampled
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)

    def make(n: int, salt: int) -> ArrayDataset:
        r = np.random.default_rng(seed + salt)
        labels = r.integers(0, num_classes, size=n).astype(np.int32)
        lengths = r.integers(max_len // 4, max_len + 1, size=n)
        tokens = np.zeros((n, max_len), dtype=np.int32)
        for c in range(num_classes):
            idx = np.nonzero(labels == c)[0]
            if idx.size == 0:
                continue
            tokens[idx] = r.choice(vocab_size, size=(idx.size, max_len), p=probs[c])
        mask = np.arange(max_len)[None, :] < lengths[:, None]
        tokens = np.where(mask, tokens, 0).astype(np.int32)
        return ArrayDataset(tokens, labels)

    return DatasetCollection(
        name=name,
        datasets={
            Phase.Training: make(train_size, 11),
            Phase.Validation: make(val_size, 12),
            Phase.Test: make(test_size, 13),
        },
        num_classes=num_classes,
        input_shape=(max_len,),
        dataset_type="text",
        metadata={"vocab_size": vocab_size, "max_len": max_len, "pad_id": 0},
    )


def _text_factory(name: str, num_classes: int, default_train: int):
    @register_dataset(name)
    def factory(
        max_len: int = 300,
        vocab_size: int = 20000,
        train_size: int = default_train,
        val_size: int = 0,
        test_size: int = 0,
        tokenizer: dict | str | None = None,
        **_: object,
    ) -> DatasetCollection:
        from .tokenizer import resolve_tokenizer_type

        _refuse_real_data(name)
        resolve_tokenizer_type(tokenizer, None)  # reject unknown types loudly
        val_size_ = val_size or max(256, train_size // 8)
        test_size_ = test_size or max(512, train_size // 4)
        return _synthetic_text(
            name, num_classes, vocab_size, max_len, train_size, val_size_, test_size_
        )

    return factory


_text_factory("imdb", 2, 4096)
_text_factory("IMDB", 2, 4096)
_text_factory("AGNews", 4, 8192)


def _synthetic_graph(
    name: str,
    num_nodes: int,
    num_features: int,
    num_classes: int,
    avg_degree: int = 10,
    homophily: float = 0.8,
) -> DatasetCollection:
    """Stochastic-block-model node-classification graph with class-prototype
    features; the numpy calls are the JAX package's, in its order, so every
    array is byte-equal.  Each phase is the whole graph with its own node
    mask (60/20/20 of a permutation)."""
    rng = np.random.default_rng(_seed_for(name))
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    prototypes = rng.normal(0, 1.0, size=(num_classes, num_features)).astype(np.float32)
    x = prototypes[labels] + rng.normal(0, 0.6, size=(num_nodes, num_features)).astype(np.float32)

    n_edges = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, size=2 * n_edges)
    # homophilous wiring: with probability `homophily` the destination is
    # redrawn from the source's class
    dst = rng.integers(0, num_nodes, size=2 * n_edges)
    same = rng.random(2 * n_edges) < homophily
    by_class = [np.nonzero(labels == c)[0] for c in range(num_classes)]
    for c in range(num_classes):
        idx = np.nonzero(same & (labels[src] == c))[0]
        if idx.size and by_class[c].size:
            dst[idx] = rng.choice(by_class[c], size=idx.size)
    keep = src != dst
    edge_index = np.stack([src[keep], dst[keep]])[:, :n_edges]
    edge_index = np.concatenate([edge_index, edge_index[::-1]], axis=1).astype(np.int32)  # symmetric

    perm = rng.permutation(num_nodes)
    n_train = int(num_nodes * 0.6)
    n_val = int(num_nodes * 0.2)
    masks = {}
    for phase, nodes in (
        (Phase.Training, perm[:n_train]),
        (Phase.Validation, perm[n_train : n_train + n_val]),
        (Phase.Test, perm[n_train + n_val :]),
    ):
        mask = np.zeros(num_nodes, dtype=bool)
        mask[nodes] = True
        masks[phase] = mask
    datasets = {
        phase: ArrayDataset(inputs={"x": x, "edge_index": edge_index, "mask": masks[phase]}, targets=labels)
        for phase in masks
    }
    return DatasetCollection(
        name=name,
        datasets=datasets,
        num_classes=num_classes,
        input_shape=(num_features,),
        dataset_type="graph",
        metadata={"num_nodes": num_nodes, "num_edges": int(edge_index.shape[1])},
    )


def _graph_factory(name: str, num_nodes: int, num_features: int, num_classes: int):
    @register_dataset(name)
    def factory(num_nodes_: int = 0, num_features_: int = 0, **_: object) -> DatasetCollection:
        _refuse_real_data(name)
        return _synthetic_graph(name, num_nodes_ or num_nodes, num_features_ or num_features, num_classes)

    return factory


# the real datasets' class counts; node and feature counts scaled down
_graph_factory("Cora", 2048, 128, 7)
_graph_factory("PubMed", 2048, 128, 3)
_graph_factory("Coauthor_CS", 4096, 128, 15)
_graph_factory("dblp", 2048, 128, 4)
_graph_factory("reddit", 4096, 128, 41)
_graph_factory("Reddit", 4096, 128, 41)
_graph_factory("yelp", 4096, 128, 10)
_graph_factory("AmazonProduct", 4096, 128, 12)
_graph_factory("amazonproduct", 4096, 128, 12)


@register_dataset("CitationFull")
def _citation_full(name: str = "DBLP", **kwargs: object) -> DatasetCollection:
    """``conf/fed_aas/dblp.yaml`` picks a CitationFull sub-dataset through
    ``dataset_kwargs: {name: DBLP}``; its size is fixed, as in the JAX
    package (no ``num_nodes_``)."""
    class_counts = {"DBLP": 4, "Cora": 70, "Cora_ML": 7, "CiteSeer": 6, "PubMed": 3}
    return _synthetic_graph(f"CitationFull_{name}", 2048, 128, class_counts.get(str(name), 4))
