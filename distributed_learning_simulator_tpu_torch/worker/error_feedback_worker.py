"""Compressed delta uploads with error feedback (the port's copy of the JAX
package's ``worker/error_feedback_worker.py``): the worker keeps a
residual of what it has not sent, ships ``sparsify(delta + residual)`` and
keeps the rest.  The residual is written each upload to
``worker_N/error_feedback.npz`` (JAX keys and layouts, tagged
``__round__``); restoring it on resume belongs to the threaded executor's
resume, which is not ported (``training.py``)."""

import os
from typing import Any

import numpy as np

from ..message import DeltaParameterMessage, Params
from ..models.convert import to_jax
from .aggregation_worker import AggregationWorker


class ErrorFeedbackWorker(AggregationWorker):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        assert self._send_parameter_diff, "error feedback needs diff uploads"
        self._error: Params | None = None

    def _sparsify(self, delta: Params) -> Params:
        """Subclass hook: the (sparse) payload actually sent."""
        raise NotImplementedError

    def _get_sent_data(self) -> DeltaParameterMessage:
        message = super()._get_sent_data()
        assert isinstance(message, DeltaParameterMessage)
        delta = message.delta_parameter
        if self._error is not None:
            delta = {k: v + self._error[k] if k in self._error else v for k, v in delta.items()}
        sent = self._sparsify(delta)
        self._error = {k: delta[k] - sent[k] if k in sent else delta[k] for k in delta}
        # .npz suffix keeps np.savez from appending one to the tmp name
        tmp = os.path.join(self.save_dir, "error_feedback.tmp.npz")
        np.savez(tmp, __round__=np.asarray(self._round_num), **to_jax(self._error))
        os.replace(tmp, os.path.join(self.save_dir, "error_feedback.npz"))
        message.delta_parameter = sent
        return message
