"""Quantized endpoints (the port's copy of the stochastic part of the JAX
package's ``topology/quantized_endpoint.py``): endpoints that encode the
parameter payload of a message on ``send``/``broadcast`` and decode it on
``get``, logging each encode's compression ratio.

The codec (``ops/quantization.py``) sees the payload in the JAX package's
keys and layouts (``models/convert.py::to_jax_tensors``), so each leaf's
values meet their random draws in the JAX package's order; decode returns
the port's keys and layouts.  QSGD's endpoints take a one-shot aligned key
(``set_quant_key``: a :class:`~..ops.quantization.SessionKey` from a
threaded role) for their next encode; NNADQ is deterministic and takes
none.
"""

import dataclasses
from typing import Any

from ..message import DeltaParameterMessage, Message, ParameterMessage
from ..models.convert import from_jax_tensors, to_jax_tensors
from ..ops.quantization import NNADQ, blob_nbytes, check_compression_ratio, stochastic_quantization
from ..utils.logging import get_logger
from .central_topology import ClientEndpoint, ServerEndpoint


def _payload_field(message: Any) -> str | None:
    if isinstance(message, ParameterMessage):
        return "parameter"
    if isinstance(message, DeltaParameterMessage):
        return "delta_parameter"
    return None


class _EncodedPayload:
    """A quantized payload travelling through an endpoint."""

    __slots__ = ("blob",)

    def __init__(self, blob: dict) -> None:
        self.blob = blob

    @property
    def nbytes(self) -> int:
        """Compressed wire size (what the byte counters count)."""
        return blob_nbytes(self.blob)


class _QuantCodecMixin:
    """Quantize on the way out, dequantize on the way in.  ``flat_payload``
    sends a whole payload as one ParamVec leaf (the codec's flat branch);
    an encode with an aligned key stays per leaf."""

    def _init_codec(self, name: str, flat_payload: bool = False) -> None:
        self._codec_name = name
        self._quant_seed = 0
        self.flat_payload = bool(flat_payload)
        self.compression_ratios: list[float] = []

    def _quant(self, tree):  # subclass hook
        raise NotImplementedError

    def _dequant(self, blob):  # subclass hook
        raise NotImplementedError

    def _after_quant(self, original, encoded) -> None:
        ratio = check_compression_ratio(original, encoded)
        self.compression_ratios.append(ratio)
        get_logger().info("%s compression ratio: %.6f", self._codec_name, ratio)

    def _encode(self, message: Any) -> Any:
        field = _payload_field(message)
        if field is None or getattr(message, "is_initial", False):
            return message
        payload = getattr(message, field)
        encoded = self._quant(to_jax_tensors(payload))
        self._after_quant(payload, encoded)
        return dataclasses.replace(message, **{field: _EncodedPayload(encoded)})

    def _decode(self, message: Any) -> Any:
        field = _payload_field(message)
        if field is None:
            return message
        payload = getattr(message, field)
        if isinstance(payload, _EncodedPayload):
            decoded = from_jax_tensors(self._dequant(payload.blob))
            return dataclasses.replace(message, **{field: decoded})
        return message


class QuantClientEndpoint(_QuantCodecMixin, ClientEndpoint):
    """Encodes uploads; decodes server messages when
    ``dequant_server_data`` (FedOBD turns it on with the server's
    ``quant_broadcast``)."""

    def __init__(self, topology, worker_id, dequant_server_data: bool = True,
                 flat_payload: bool = False, random=None) -> None:
        ClientEndpoint.__init__(self, topology, worker_id, random=random)
        self._init_codec(type(self).__name__, flat_payload=flat_payload)
        self.dequant_server_data = dequant_server_data

    def send(self, data: Any) -> None:
        if isinstance(data, Message):
            data = self._encode(data)
        super().send(data)

    def get(self, timeout: float | None = None) -> Any:
        data = super().get(timeout=timeout)
        if isinstance(data, Message) and self.dequant_server_data:
            data = self._decode(data)
        return data


class QuantServerEndpoint(_QuantCodecMixin, ServerEndpoint):
    """Decodes uploads; encodes broadcasts when ``quant_broadcast``.  A
    broadcast is encoded once and the same encoded message goes to every
    receiver."""

    def __init__(self, topology, quant_broadcast: bool = False, flat_payload: bool = False, random=None) -> None:
        ServerEndpoint.__init__(self, topology, random=random)
        self._init_codec(type(self).__name__, flat_payload=flat_payload)
        self.quant_broadcast = quant_broadcast

    def get(self, worker_id: int, timeout: float | None = None) -> Any:
        data = super().get(worker_id, timeout=timeout)
        if isinstance(data, Message):
            data = self._decode(data)
        return data

    def send(self, worker_id: int, data: Any) -> None:
        if self.quant_broadcast and isinstance(data, Message):
            data = self._encode(data)
        super().send(worker_id, data)

    def broadcast(self, data: Any, worker_ids: set[int] | None = None) -> None:
        if self.quant_broadcast and isinstance(data, Message):
            data = self._encode(data)
        for worker_id in range(self.worker_num):
            if worker_ids is None or worker_id in worker_ids:
                ServerEndpoint.send(self, worker_id, data)


class _AlignedKeyMixin:
    """A one-shot key (and optional global fold-index map) for the next
    encode, which then takes the codec's keyed per-leaf branch."""

    _pending_key = None
    _pending_fold = None

    def set_quant_key(self, key, fold_indices=None) -> None:
        self._pending_key = key
        self._pending_fold = fold_indices

    def _take_key(self):
        key, self._pending_key = self._pending_key, None
        fold, self._pending_fold = self._pending_fold, None
        return key, fold


class StochasticQuantClientEndpoint(_AlignedKeyMixin, QuantClientEndpoint):
    """QSGD with ``quantization_level`` levels (255 by default); a flat
    ParamVec payload unless ``flat_payload: false``.  ``random`` is the
    codec's random source (``ops/quantization.py::CodecRandom``)."""

    def __init__(self, topology, worker_id, quantization_level: int = 255, **kwargs):
        kwargs.setdefault("flat_payload", True)
        super().__init__(topology, worker_id, **kwargs)
        self._q, self._dq = stochastic_quantization(quantization_level, random=self.random)

    def _quant(self, tree):
        key, fold = self._take_key()
        if key is not None:
            return self._q(tree, key=key, fold_indices=fold)
        self._quant_seed += 1
        return self._q(tree, seed=self._quant_seed * 2 + self.worker_id, flat=self.flat_payload)

    def _dequant(self, blob):
        return self._dq(blob)


class StochasticQuantServerEndpoint(_AlignedKeyMixin, QuantServerEndpoint):
    def __init__(self, topology, quantization_level: int = 255, **kwargs):
        kwargs.setdefault("flat_payload", True)
        super().__init__(topology, **kwargs)
        self._q, self._dq = stochastic_quantization(quantization_level, random=self.random)

    def _quant(self, tree):
        key, fold = self._take_key()
        if key is not None:
            return self._q(tree, key=key, fold_indices=fold)
        self._quant_seed += 1
        return self._q(tree, seed=self._quant_seed * 2 + 1, flat=self.flat_payload)

    def _dequant(self, blob):
        return self._dq(blob)


class NNADQClientEndpoint(QuantClientEndpoint):
    """NNADQ with the trade-off ``weight`` of ``endpoint_kwargs``: per leaf
    unless ``flat_payload``, which trades the per-leaf widths for one
    encode of the whole model."""

    def __init__(self, topology, worker_id, weight: float = 0.01, **kwargs):
        super().__init__(topology, worker_id, **kwargs)
        self._codec = NNADQ(weight=weight)

    def _quant(self, tree):
        return self._codec.quant(tree, flat=self.flat_payload)

    def _dequant(self, blob):
        return self._codec.dequant(blob)


class NNADQServerEndpoint(QuantServerEndpoint):
    def __init__(self, topology, weight: float = 0.01, **kwargs):
        super().__init__(topology, **kwargs)
        self._codec = NNADQ(weight=weight)

    def _quant(self, tree):
        return self._codec.quant(tree, flat=self.flat_payload)

    def _dequant(self, blob):
        return self._codec.dequant(blob)
