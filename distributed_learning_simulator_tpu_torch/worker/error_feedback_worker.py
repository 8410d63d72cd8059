"""Compressed delta uploads with error feedback (the port's copy of the JAX
package's ``worker/error_feedback_worker.py``): the worker keeps a
residual of what it has not sent, ships ``sparsify(delta + residual)`` and
keeps the rest.  The residual is written each upload to
``worker_N/error_feedback.npz`` (JAX keys and layouts, tagged
``__round__``).  With ``algorithm_kwargs.resume_dir`` the worker restores
it from the same file of the resumed run, unless its tag is past the
round the server resumes from (a residual of a round that was never
checkpointed); an older tag is the state of the worker's last
participation, which an uninterrupted run carries too."""

import os
from typing import Any

import numpy as np

from ..message import DeltaParameterMessage, Params
from ..models.convert import from_jax, to_jax
from ..util.resume import resumable_round
from ..utils.logging import get_logger
from .aggregation_worker import AggregationWorker


class ErrorFeedbackWorker(AggregationWorker):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        assert self._send_parameter_diff, "error feedback needs diff uploads"
        self._error: Params | None = None

    def _sparsify(self, delta: Params) -> Params:
        """Subclass hook: the (sparse) payload actually sent."""
        raise NotImplementedError

    def _before_training(self) -> None:
        resume_dir = self.config.algorithm_kwargs.get("resume_dir")
        if resume_dir:
            path = os.path.join(str(resume_dir), os.path.basename(self.save_dir), "error_feedback.npz")
            restored = self._load_residual(path, str(resume_dir))
            if restored is not None:
                self._error = restored
                get_logger().info("%s: restored error-feedback residual", self.name)
            else:
                get_logger().warning(
                    "%s: resume without a usable error_feedback.npz — residual restarts at zero", self.name
                )
        super()._before_training()

    def _load_residual(self, path: str, resume_dir: str) -> Params | None:
        """The residual of ``path`` on the model's device, or None when the
        file is missing, unreadable, untagged or tagged past the server's
        resumable round."""
        if not os.path.isfile(path):
            return None
        try:
            with np.load(path) as blob:
                data = {k: blob[k] for k in blob.files}
        except Exception as exc:  # noqa: BLE001 -- a torn file of any shape
            get_logger().warning("%s: error_feedback.npz unreadable (%s)", self.name, exc)
            return None
        tag = data.pop("__round__", None)
        server_round = resumable_round(resume_dir)
        if tag is None or int(tag) > server_round:
            get_logger().warning(
                "%s: residual round tag %s is ahead of resumable round %d", self.name, tag, server_round
            )
            return None
        device = self._task_context.model_ctx.device
        return {k: v.to(device) for k, v in from_jax(data).items()}

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
