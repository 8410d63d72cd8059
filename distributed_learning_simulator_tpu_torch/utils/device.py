"""Where the port runs: CUDA unless the caller asks for the CPU, and at
what precision its f32 products run there."""

import torch


def keep_f32_products_f32() -> None:
    """f32 matrix products and convolutions stay f32 on the card: PyTorch
    lets cuDNN run f32 convolutions in TF32 unless told otherwise (its f32
    matmuls already default to f32).  The CPU tests and the card-vs-CPU
    checks hold f32 results to f32 tolerances, so TF32 stays off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str | torch.device | None) -> torch.device:
    """``torch.device`` for ``name`` (default ``"cuda"``).  Asking for CUDA
    where no GPU is visible raises: the port never drops to the CPU unless
    the caller names it.  Sets the f32 precision
    (:func:`keep_f32_products_f32`) for every run."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {device}")
    keep_f32_products_f32()
    return device
