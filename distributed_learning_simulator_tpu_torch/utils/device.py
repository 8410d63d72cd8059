"""Where the port runs: CUDA unless the caller asks for the CPU."""

import torch


def resolve_device(name: str | torch.device | None) -> torch.device:
    """``torch.device`` for ``name`` (default ``"cuda"``).  Asking for CUDA
    where no GPU is visible raises: the port never drops to the CPU unless
    the caller names it."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {device}")
    return device
