"""Dataset registry with the deterministic synthetic generators.

The port's copy of the JAX package's ``data/registry.py`` for the vision
and text datasets: class-prototype images plus scale jitter and gaussian
noise, and class-dependent unigram token streams, all from numpy
``default_rng`` seeded by the dataset's name, so the arrays are
byte-equal to the JAX package's.  Real data on disk
(``$DLS_TPU_DATA_DIR/<name>.npz``) and graph datasets are not ported yet
and raise rather than give different data.
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
