"""FedAvg's weighted reduction ``sum_c w[c] * X[c]`` into an f32 vector.

The port of ``ops/pallas_kernels.py::weighted_accum`` (kernel K1): the
CUDA kernel is ``csrc/weighted_accum.cu``.  :func:`weighted_accum` launches
it for CUDA tensors and raises on anything it does not take; for CPU
tensors it computes :func:`weighted_accum_plain`, the same function in
plain PyTorch, which the tests and ``chip_smoke.py`` hold the kernel to.

:func:`plan` is the one place that chooses how the kernel runs: its
variant (``"split"``: the row groups of a warp share the rows of its
columns, for many rows of few columns; ``"stream"``: one thread walks all
rows of its columns; ``"scalar"``: one element a load, for rows that are
not 16-byte aligned) and its launch shape.  The C entry checks the plan
and refuses (``cudaErrorInvalidValue``) one it cannot run; the wrapper
raises.  ``route_launches`` counts launches per variant; ``launches`` is
their total.
"""

import ctypes
from dataclasses import dataclass

import torch

from . import build

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

#: the variants, by the code the C entry takes
VARIANTS = {"split": 0, "stream": 1, "scalar": 2}
#: launches per variant since last set to 0
route_launches = {variant: 0 for variant in VARIANTS}

#: the H100 SXM's streaming multiprocessors
SMS = 132
#: rows whose loads a split thread has in flight together (the kernel's
#: chunk): more rows than this and few column items take "split"
SPLIT_ROWS = 8
#: fewest column items (16-byte vectors) that give every SM a block of 256
#: threads: below it, more than SPLIT_ROWS rows take "split"
STREAM_MIN_ITEMS = SMS * 256
#: rows of more bytes than this come from device memory, not from the 50 MB
#: L2 the caller has just written them to
L2_RESIDENT_BYTES = 24 * 2**20
#: (threads, vectors a row, rows a chunk) of each variant, as built in
#: csrc/weighted_accum.cu and chosen by device time on an H100
#: (``PERF.md``): "split" one vector of 8 rows; "stream" in L2 f32 one
#: vector of 4 rows and bf16 two vectors of a row, in 128-thread blocks;
#: "stream" from device memory four vectors of 2 rows; "scalar" the same
SPLIT = (128, 1, SPLIT_ROWS)
STREAM_L2 = {torch.float32: (128, 1, 4), torch.bfloat16: (128, 2, 1)}
STREAM_HBM = (256, 4, 2)
SCALAR = (256, 4, 2)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_bound = None


@dataclass(frozen=True)
class Plan:
    """How the kernel runs ``[c, n]``: ``blocks`` blocks of ``threads``
    threads; each warp's 32 lanes form ``32 // lanes`` row groups of
    ``lanes`` lanes, group g summing rows ``[g * rows, (g + 1) * rows)``; a
    lane owns ``vectors`` column items of ``width`` values a tile (item j
    of tile t at ``t * cols * vectors + j * cols + ct``, ``cols = threads //
    32 * lanes``, ``ct`` the lane's place among them), and the blocks walk
    the tiles ``blocks`` apart; ``padded``: the last, partial item is read
    whole from the row padding."""

    variant: str
    width: int
    blocks: int
    threads: int
    lanes: int
    rows: int
    vectors: int
    unroll: int
    padded: bool

    @property
    def cols(self) -> int:
        return self.threads // 32 * self.lanes

    def items(self, n: int) -> int:
        return -(-n // self.width)

    def tiles(self, n: int) -> int:
        return -(-self.items(n) // (self.cols * self.vectors))


def plan(c: int, n: int, ld: int, dtype: torch.dtype, aligned: bool, extent: int | None = None) -> Plan:
    """The variant and launch shape for ``c`` rows of ``n`` values of
    ``dtype`` at row stride ``ld`` (``aligned``: the first row starts on a
    16-byte boundary; ``extent``: elements readable from it, ``c * ld`` by
    default).  Rows on 16-byte strides take 16-byte loads: ``"split"``
    where more than ``SPLIT_ROWS`` rows meet fewer than
    ``STREAM_MIN_ITEMS`` column items (row groups of a warp share the rows,
    the widest groups whose rows fit one chunk of loads), ``"stream"``
    otherwise (a thread walks all rows of its items); other rows take
    ``"scalar"``.  Every grid is a block a tile: a persistent grid left a
    tail of tiles on some SMs (``PERF.md``)."""
    if c < 1 or n < 1:
        raise ValueError(f"weighted_accum plans [c >= 1, n >= 1], got [{c}, {n}]")
    extent = c * ld if extent is None else extent
    width = 16 // _ITEMSIZE[dtype]
    if not (aligned and ld % width == 0):
        threads, vectors, unroll = SCALAR
        return Plan("scalar", 1, -(-n // (threads * vectors)), threads, 32, c, vectors, unroll, False)
    items = -(-n // width)
    padded = n % width != 0 and ld >= items * width and (c - 1) * ld + items * width <= extent
    if c > SPLIT_ROWS and items < STREAM_MIN_ITEMS:
        threads, vectors, unroll = SPLIT
        lanes = 32
        while lanes > 1 and -(-c // (32 // lanes)) > SPLIT_ROWS:
            lanes //= 2
        rows = -(-c // (32 // lanes))
        blocks = -(-items // (threads // 32 * lanes))
        return Plan("split", width, blocks, threads, lanes, rows, vectors, unroll, padded)
    in_l2 = c * n * _ITEMSIZE[dtype] <= L2_RESIDENT_BYTES
    threads, vectors, unroll = STREAM_L2[dtype] if in_l2 else STREAM_HBM
    blocks = -(-items // (threads * vectors))
    return Plan("stream", width, blocks, threads, 32, c, vectors, unroll, padded)


def _library():
    global _bound
    if _bound is None:
        lib = build.load("weighted_accum")
        fn = lib.weighted_accum
        fn.argtypes = [
            ctypes.c_int,  # dtype
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # w
            ctypes.c_void_p,  # out
            ctypes.c_int64,  # c
            ctypes.c_int64,  # n
            ctypes.c_int64,  # ld
            ctypes.c_int64,  # extent
            ctypes.c_int,  # variant
            ctypes.c_int64,  # blocks
            ctypes.c_int,  # threads
            ctypes.c_int,  # lanes
            ctypes.c_int,  # rows
            ctypes.c_int,  # vectors
            ctypes.c_int,  # unroll
            ctypes.c_int,  # padded
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def weighted_accum_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_c w[c] * x[c]`` accumulated in f32, client by client (the
    stream variant's order)."""
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
    if x.shape[0] == 0:
        raise ValueError("weighted_accum wants at least one row")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"weighted_accum takes f32 or bf16 rows, got {x.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"weighted_accum takes f32 weights, got {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")


def layout(x: torch.Tensor) -> tuple[int, bool, int]:
    """``(ld, aligned, extent)`` of a ``[C, N]`` operand for :func:`plan`;
    one row's stride is free, so it is taken as its 16-byte-rounded width."""
    c, n = x.shape
    width = 16 // x.element_size()
    ld = x.stride(0) if c > 1 else -(-n // width) * width
    extent = x.untyped_storage().nbytes() // x.element_size() - x.storage_offset()
    return ld, x.data_ptr() % 16 == 0, extent


def weighted_accum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_c w[c] * x[c]`` for ``x: [C, N]`` (f32 or bf16 rows, unit
    column stride, any row stride) and ``w: [C]`` f32; returns f32 ``[N]``
    without a ``[C, N]`` temporary."""
    return _launch(x, w, None)


def _launch(x: torch.Tensor, w: torch.Tensor, chosen: Plan | None) -> torch.Tensor:
    """:func:`weighted_accum` on the plan ``chosen`` (None: :func:`plan`'s);
    the C entry refuses a plan it cannot run."""
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
    if n == 0:
        return out
    ld, aligned, extent = layout(x)
    p = chosen or plan(c, n, ld, x.dtype, aligned, extent)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _library()(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(),
            w.data_ptr(),
            out.data_ptr(),
            c,
            n,
            ld,
            extent,
            VARIANTS[p.variant],
            p.blocks,
            p.threads,
            p.lanes,
            p.rows,
            p.vectors,
            p.unroll,
            int(p.padded),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"weighted_accum kernel launch failed ({p}): CUDA error {err}")
    with build.launch_lock:
        launches += 1
        route_launches[p.variant] += 1
    return out
