"""Server-side aggregation algorithm base (the port's copy of the JAX
package's ``algorithm/aggregation_algorithm.py``): restores delta uploads
onto the old global parameters and completes partial uploads from it; a
worker that skipped the round sends ``None``.  The update guard of the
fault plan stays refused (``training.py``)."""

from typing import Any

import torch

from ..message import DeltaParameterMessage, Message, ParameterMessage, Params
from ..utils.logging import get_logger


class AggregationAlgorithm:
    def __init__(self, server=None) -> None:
        self._server = server
        self._all_worker_data: dict[int, Message] = {}
        self._old_parameter_dict: Params | None = None
        self._config = None

    def set_server(self, server) -> None:
        self._server = server

    def set_config(self, config) -> None:
        self._config = config

    def process_worker_data(
        self,
        worker_id: int,
        worker_data: Message | None,
        old_parameter_dict: Params | None = None,
        **kwargs: Any,
    ) -> None:
        """Normalize one worker's upload into a full :class:`ParameterMessage`."""
        if worker_data is None:
            get_logger().debug("worker %s skipped this round", worker_id)
            return
        if old_parameter_dict is not None:
            self._old_parameter_dict = old_parameter_dict
        match worker_data:
            case DeltaParameterMessage():
                assert self._old_parameter_dict is not None
                worker_data = worker_data.restore(self._old_parameter_dict)
            case ParameterMessage():
                if self._old_parameter_dict is not None:
                    worker_data.complete(self._old_parameter_dict)
        self._all_worker_data[worker_id] = worker_data

    def aggregate_worker_data(self) -> Message:
        raise NotImplementedError

    def clear_worker_data(self) -> None:
        self._all_worker_data.clear()

    def exit(self) -> None:
        pass


def check_finite(vec: torch.Tensor, layout=None) -> None:
    """NaN guard on an aggregate: one reduction on the happy path; a
    failure names the first non-finite parameter."""
    finite = torch.isfinite(vec)
    if bool(finite.all()):
        return
    bad = int((~finite).nonzero()[0, 0])
    name = f"vector[{bad}]"
    if layout is not None:
        start = 0
        for key, shape in zip(layout.keys, layout.shapes):
            size = int(torch.Size(shape).numel())
            if bad < start + size:
                name = key
                break
            start += size
    raise FloatingPointError(f"non-finite aggregated parameter {name}")
