"""Messages between the threaded executor's server and workers (the port's
copy of the JAX package's ``message.py``).

A message carries control fields and a parameter payload: a
``dict[str, Tensor]`` handed over by reference inside one process, or an
encoded payload on a quantized link, which reports its wire size through
``nbytes``.  ``other_data`` may carry arrays too (graph FL's boundary
embeddings on the device, their node ids in numpy), and they count.
"""

import dataclasses
from typing import Any

import numpy as np
import torch

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(kw_only=True)
class Message:
    other_data: dict[str, Any] = dataclasses.field(default_factory=dict)
    in_round: bool = False  # does not advance the round counter
    end_training: bool = False


@dataclasses.dataclass(kw_only=True)
class ParameterMessageBase(Message):
    is_initial: bool = False


@dataclasses.dataclass(kw_only=True)
class ParameterMessage(ParameterMessageBase):
    parameter: Params
    dataset_size: int = 0

    def complete(self, old_parameter: Params) -> "ParameterMessage":
        """Fill the keys a partial upload left out from the old global."""
        for key, value in old_parameter.items():
            if key not in self.parameter:
                self.parameter[key] = value
        return self


@dataclasses.dataclass(kw_only=True)
class DeltaParameterMessage(ParameterMessageBase):
    delta_parameter: Params
    dataset_size: int = 0

    def restore(self, old_parameter: Params) -> ParameterMessage:
        """The old global plus the deltas; keys without a delta keep the
        old value."""
        parameter = {k: old_parameter[k] + self.delta_parameter[k] for k in self.delta_parameter}
        for key, value in old_parameter.items():
            parameter.setdefault(key, value)
        return ParameterMessage(
            parameter=parameter,
            dataset_size=self.dataset_size,
            other_data=self.other_data,
            in_round=self.in_round,
            end_training=self.end_training,
        )


def param_nbytes(params: Params) -> int:
    return sum(t.numel() * t.element_size() for t in params.values())


def payload_nbytes(value: Any) -> int:
    """Bytes of the arrays in ``value``, tensors and numpy arrays at any
    depth of its dicts, lists and tuples (the JAX package's ``param_nbytes``
    over a pytree's leaves); any other leaf counts 0."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, (np.ndarray, np.generic)):
        return int(value.nbytes)
    if isinstance(value, dict):
        return sum(payload_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(payload_nbytes(v) for v in value)
    return 0


def get_message_size(message: Message) -> int:
    """Payload bytes of a message: the arrays of its dict fields, or an
    encoded payload's wire size."""
    total = 0
    for field in dataclasses.fields(message):
        value = getattr(message, field.name)
        if isinstance(value, dict):
            total += payload_nbytes(value)
        elif hasattr(value, "nbytes"):
            total += int(value.nbytes)
    return total
