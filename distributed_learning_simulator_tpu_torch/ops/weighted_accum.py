"""FedAvg's weighted reduction ``sum_c w[c] * X[c]`` into an f32 vector.

The port of ``ops/pallas_kernels.py::weighted_accum`` (kernel K1): the
CUDA kernel is ``csrc/weighted_accum.cu``.  :func:`weighted_accum` launches
it for CUDA tensors and raises on anything it does not take; for CPU
tensors it computes :func:`weighted_accum_plain`, the same function in
plain PyTorch, which the tests and ``chip_smoke.py`` hold the kernel to.
"""

import ctypes

import torch

from . import build

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound = None


def _library():
    global _bound
    if _bound is None:
        lib = build.load("weighted_accum")
        fn = lib.weighted_accum
        fn.argtypes = [
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def weighted_accum_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_c w[c] * x[c]`` accumulated in f32, client by client (the
    kernel's order)."""
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for c in range(x.shape[0]):
        out += w[c].float() * x[c].float()
    return out


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[0]:
        raise ValueError(
            f"weighted_accum wants x [C, N] and w [C], got {tuple(x.shape)}"
            f" and {tuple(w.shape)}"
        )
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"weighted_accum takes f32 or bf16 rows, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"weighted_accum takes f32 weights, got {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")


def weighted_accum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_c w[c] * x[c]`` for ``x: [C, N]`` (f32 or bf16 rows, unit
    column stride, any row stride) and ``w: [C]`` f32; returns f32 ``[N]``
    without a ``[C, N]`` temporary."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return weighted_accum_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"weighted_accum runs on cuda or cpu, not {x.device}")
    if x.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("weighted_accum wants unit-stride rows and contiguous weights")
    c, n = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _library()(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
            c,
            n,
            x.stride(0),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"weighted_accum kernel launch failed: CUDA error {err}")
    with build.launch_lock:
        launches += 1
    return out
