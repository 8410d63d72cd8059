"""Server-side aggregation algorithm base (the port's copy of the JAX
package's ``algorithm/aggregation_algorithm.py``): restores delta uploads
onto the old global parameters and completes partial uploads from it; a
worker that skipped the round sends ``None``.  Under the fault plan's
update guard (``fault_tolerance.update_guard``, ``max_update_norm``) an
upload that is not finite, or whose change from the old global is too
long, is rejected before it reaches any accumulator: it counts in
:attr:`AggregationAlgorithm.rejected_workers` and as a skipped worker, and
the round renormalises over the survivors."""

from typing import Any

import numpy as np
import torch

from ..message import DeltaParameterMessage, Message, ParameterMessage, Params
from ..models.convert import _jax_key
from ..util.faults import FaultPlan
from ..utils.logging import get_logger


class AggregationAlgorithm:
    def __init__(self, server=None) -> None:
        self._server = server
        self._all_worker_data: dict[int, Message] = {}
        self._skipped_workers: set[int] = set()
        self._rejected_workers: set[int] = set()
        self._old_parameter_dict: Params | None = None
        self._config = None
        self._fault_plan: FaultPlan | None = None

    def set_server(self, server) -> None:
        self._server = server

    def set_config(self, config) -> None:
        self._config = config
        self._fault_plan = FaultPlan.from_config(config) if config is not None else None

    @property
    def all_worker_data(self) -> dict[int, Message]:
        return self._all_worker_data

    @property
    def skipped_workers(self) -> set[int]:
        return self._skipped_workers

    @property
    def rejected_workers(self) -> set[int]:
        """The workers whose uploads the update guard rejected this round."""
        return self._rejected_workers

    def process_worker_data(
        self,
        worker_id: int,
        worker_data: Message | None,
        old_parameter_dict: Params | None = None,
        **kwargs: Any,
    ) -> None:
        """Normalize one worker's upload into a full :class:`ParameterMessage`."""
        if worker_data is None:
            self._skipped_workers.add(worker_id)
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
        if isinstance(worker_data, ParameterMessage) and not update_passes_guard(
            self._fault_plan, worker_id, worker_data.parameter, self._old_parameter_dict
        ):
            self._rejected_workers.add(worker_id)
            self._skipped_workers.add(worker_id)
            return
        self._all_worker_data[worker_id] = worker_data

    def aggregate_worker_data(self) -> Message:
        raise NotImplementedError

    def clear_worker_data(self) -> None:
        self._all_worker_data.clear()
        self._skipped_workers.clear()
        self._rejected_workers.clear()

    def exit(self) -> None:
        pass


def update_passes_guard(plan: FaultPlan | None, worker_id: int, parameter: Params, old_params: Params | None) -> bool:
    """The server's update guard (a function of its own, so a buffered
    flush can guard each upload against its own origin's global): False
    for an upload with a non-finite tensor, or whose change from
    ``old_params`` is longer than ``plan.max_update_norm``.  Every tensor's
    verdict and squared change are taken on its device and read in one
    copy to the host."""
    if plan is None or not plan.update_guard:
        return True
    names = list(parameter)
    norm = plan.max_update_norm > 0 and bool(old_params)
    stats = []
    for name in names:
        value = parameter[name].to(torch.float32)
        sq = torch.zeros((), device=value.device)
        old = old_params.get(name) if norm else None
        if old is not None:
            sq = (value - old.to(value.device, torch.float32)).square().sum()
        stats.append(torch.stack([torch.isfinite(value).all().float(), sq]))
    host = torch.stack(stats).cpu().numpy() if stats else np.zeros((0, 2), np.float32)
    for name, (finite, _) in zip(names, host):
        if not finite:
            get_logger().warning("update guard: worker %s upload %r is non-finite — rejected", worker_id, name)
            return False
    norm_sq = sum(float(sq) for sq in host[:, 1])
    if plan.max_update_norm > 0 and norm_sq > plan.max_update_norm**2:
        get_logger().warning(
            "update guard: worker %s delta norm %.3e exceeds max_update_norm=%.3e — rejected",
            worker_id, norm_sq**0.5, plan.max_update_norm,
        )
        return False
    return True


def check_finite(vec: torch.Tensor, layout=None) -> None:
    """NaN guard on an aggregate: one reduction on the happy path; a
    failure names the first non-finite parameter by its JAX key."""
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
                name = _jax_key(key, len(shape))[0]
                break
            start += size
    raise FloatingPointError(f"non-finite aggregated parameter {name}")
