"""The sign-SGD client: ships ``sign(gradient)`` each optimizer step."""

import torch

from ...worker.gradient_worker import GradientWorker


class SignSGDWorker(GradientWorker):
    def _process_gradient(self, gradient: torch.Tensor) -> torch.Tensor:
        return torch.sign(gradient)
