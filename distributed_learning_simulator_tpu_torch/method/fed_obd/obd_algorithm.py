"""Opportunistic block dropout (the port's copy of the JAX package's
``method/fed_obd/obd_algorithm.py``): group the parameters into blocks by
their top-level module, rank the blocks by the L2 norm of their change
against the cached global model divided by their size, and keep blocks
greedily under a ``(1 - dropout_rate)`` share of the parameter count.

The port's keys are the JAX paths joined by ``.`` instead of ``/``; both
separators sort below every letter, digit and ``_``, so names, blocks and
their order come out the same.  The squared changes are summed on the
device and read in one transfer.
"""

import numpy as np
import torch

from ...message import Params
from ...utils.logging import get_logger


def get_module_blocks(parameter_names: list[str]) -> list[list[str]]:
    """Group flat names by their leading module component."""
    blocks: dict[str, list[str]] = {}
    for name in sorted(parameter_names):
        blocks.setdefault(name.split(".")[0], []).append(name)
    return list(blocks.values())


class OpportunisticBlockDropoutAlgorithm:
    def __init__(self, dropout_rate: float, worker_id: int) -> None:
        self.__dropout_rate = dropout_rate
        self.__worker_id = worker_id
        self.__blocks: list[list[str]] | None = None
        self.__parameter_num = 0
        #: the names each call kept, in call order
        self.kept_history: list[list[str]] = []

    def __find_blocks(self, parameter_dict: Params) -> None:
        self.__blocks = get_module_blocks(list(parameter_dict))
        assert {n for block in self.__blocks for n in block} == set(parameter_dict)
        self.__parameter_num = sum(v.numel() for v in parameter_dict.values())
        if self.__worker_id == 0:
            get_logger().info(
                "identified %d blocks over %d parameters", len(self.__blocks), self.__parameter_num
            )

    def get_block_parameter(self, parameter_dict: Params, model_cache) -> Params:
        """The kept blocks' parameters (full values; the worker turns them
        into diffs against the cached global)."""
        if self.__blocks is None:
            self.__find_blocks(parameter_dict)
        assert self.__blocks is not None
        threshold = (1 - self.__dropout_rate) * self.__parameter_num
        cached = model_cache.parameter_dict
        names = [n for block in self.__blocks for n in block]
        per_name_sq = torch.stack(
            [torch.sum(torch.square(parameter_dict[n].float() - cached[n].float())) for n in names]
        ).tolist()
        sq = dict(zip(names, per_name_sq))
        scored = []
        for block in self.__blocks:
            size = sum(parameter_dict[n].numel() for n in block)
            # the square root in f32, as jnp.sqrt of the summed float takes it
            norm = float(np.sqrt(np.float32(sum(sq[n] for n in block))))
            scored.append((norm / size, size, block))
        kept: Params = {}
        partial_parameter_num = 0
        for _, size, block in sorted(scored, key=lambda t: t[0], reverse=True):
            if partial_parameter_num > threshold:
                break
            if partial_parameter_num + size > threshold:
                continue
            partial_parameter_num += size
            for name in block:
                kept[name] = parameter_dict[name]
        self.kept_history.append(sorted(kept))
        get_logger().info(
            "partial_parameter_num %s threshold %s parameter_num %s",
            partial_parameter_num,
            threshold,
            self.__parameter_num,
        )
        return kept
