"""Client selection, deterministic in (seed, round): the same subsets the
JAX package's ``utils/selection.py`` picks for the same config."""

import random


def select_workers(
    seed: int, round_number: int, worker_number: int, k: int | None
) -> set[int]:
    if k is None or k >= worker_number:
        return set(range(worker_number))
    rng = random.Random(seed * 1_000_003 + round_number)
    return set(rng.sample(range(worker_number), k=k))
