"""FedAvg's dataset-size-weighted average (the port's copy of the JAX
package's ``algorithm/fed_avg_algorithm.py``).

Each upload is flattened in layout order and added into ONE f32
accumulator, ``acc += w · vec``, as it arrives, and its tensors are
released at once; the aggregate is :meth:`_apply_total_weight` of the sum
(one divide by the total weight), one finite check and one split back to
the parameter dict.  Uploads are taken in arrival order.  The weight
:meth:`_get_weight` gives is one scalar an upload, or one weight an
element of its flat vector (FedDropoutAvg): the sums are elementwise, so
both are the JAX package's per-tensor arithmetic element for element.
``algorithm_kwargs.float64_parity`` (the JAX package's host float64
accumulator) and ``flat_aggregation`` are refused (``training.py``).

A subclass that sets ``accumulate = False`` (the Shapley values) keeps
every upload: each is flattened into its worker's f32 row of one ``[W,
D]`` device stack as it arrives (rows on 128-byte boundaries, an absent
worker's row zero), its dataset size beside it, and its tensors are
released.  The aggregate normalises the sizes of the rows in
:attr:`aggregate_mask` first (the JAX package's ``get_ratios``) and then
runs kernel K1 over the stack, the order of the SPMD Shapley session's
round aggregate.
"""

from typing import Any

import numpy as np
import torch

from ..message import Message, ParameterMessage
from ..ops.pytree import ParamVecLayout, flat_stack_weighted_sum, k1_stack
from .aggregation_algorithm import AggregationAlgorithm, check_finite


class FedAVGAlgorithm(AggregationAlgorithm):
    #: stream each upload into one accumulator; False keeps the stack
    accumulate = True

    def __init__(self, server=None) -> None:
        super().__init__(server=server)
        #: non-accumulating: the ``[W, D]`` f32 stack and the dataset sizes
        self.stack: torch.Tensor | None = None
        self.stack_sizes: np.ndarray | None = None
        self._vec_acc: torch.Tensor | None = None
        self._vec_layout: ParamVecLayout | None = None
        self._vec_total_weight: Any = 0.0
        self._end_training = False
        self._other_data: dict = {}

    def _get_weight(self, dataset_size: int, vec: torch.Tensor) -> Any:
        """An upload's weight: a scalar, or a tensor shaped like its flat
        f32 vector ``vec``."""
        assert dataset_size != 0
        return float(dataset_size)

    def _apply_total_weight(self, vec: torch.Tensor, total_weight: Any) -> torch.Tensor:
        return vec / total_weight

    def process_worker_data(self, worker_id, worker_data, **kwargs: Any) -> None:
        super().process_worker_data(worker_id, worker_data, **kwargs)
        data = self._all_worker_data.get(worker_id)
        if not isinstance(data, ParameterMessage):
            return
        if not self.accumulate:
            self._stack_row(worker_id, data)
            return
        if self._vec_acc is None:
            self._vec_layout = ParamVecLayout.of(data.parameter)
        assert self._vec_layout is not None
        vec = self._vec_layout.flatten(data.parameter)
        weight = self._get_weight(data.dataset_size, vec)
        if self._vec_acc is None:
            self._vec_acc = vec * weight
        else:
            self._vec_acc += vec * weight
        self._vec_total_weight = self._vec_total_weight + weight
        self._end_training |= data.end_training
        self._merge_other_data(data.other_data)
        data.parameter = {}  # release the upload's tensors now

    def _stack_row(self, worker_id: int, data: ParameterMessage) -> None:
        """An upload into its worker's row of the stack (made at the round's
        first upload, zeros)."""
        if self.stack is None:
            self._vec_layout = layout = ParamVecLayout.of(data.parameter)
            workers = self._config.worker_number
            self.stack = k1_stack(workers, layout.size, next(iter(data.parameter.values())).device)
            self.stack_sizes = np.zeros(workers, np.float32)
        self.stack[worker_id] = self._vec_layout.flatten(data.parameter)
        self.stack_sizes[worker_id] = data.dataset_size
        self._end_training |= data.end_training
        self._merge_other_data(data.other_data)
        data.parameter = {}  # release the upload's tensors now

    @property
    def aggregate_mask(self) -> np.ndarray:
        """The rows the aggregate takes: every upload of the round."""
        mask = np.zeros(len(self.stack_sizes), np.float32)
        mask[sorted(self._all_worker_data)] = 1.0
        return mask

    def _aggregate_stack(self) -> torch.Tensor:
        """K1 over the stack with the dataset sizes under
        :attr:`aggregate_mask`, normalised before the sum."""
        sizes = self.aggregate_mask * self.stack_sizes
        w = sizes / np.float32(max(float(sizes.sum()), 1e-12))
        return flat_stack_weighted_sum(self.stack, torch.from_numpy(w).to(self.stack.device))

    def _merge_other_data(self, other_data: dict) -> None:
        for key, value in other_data.items():
            if key in self._other_data and self._other_data[key] != value:
                raise RuntimeError(f"different values on key {key}")
            self._other_data[key] = value

    def aggregate_worker_data(self) -> Message:
        if not self.accumulate:
            assert self.stack is not None, "no uploads to aggregate"
            vec = self._aggregate_stack()
        else:
            assert self._vec_acc is not None and self._vec_layout is not None, "no uploads to aggregate"
            vec = self._apply_total_weight(self._vec_acc, self._vec_total_weight)
        check_finite(vec, self._vec_layout)
        parameter = self._vec_layout.split(vec)
        self._vec_acc = None
        self._vec_total_weight = 0.0
        return ParameterMessage(
            parameter=parameter, end_training=self._end_training, other_data=dict(self._other_data)
        )

    def clear_worker_data(self) -> None:
        super().clear_worker_data()
        self.stack = None
        self.stack_sizes = None
        self._vec_acc = None
        self._vec_layout = None
        self._vec_total_weight = 0.0
        self._end_training = False
        self._other_data = {}
