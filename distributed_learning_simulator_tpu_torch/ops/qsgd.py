"""The QSGD codec of one flat leaf, in the TPU kernels' row-grouped layout.

The port of ``ops/pallas_kernels.py::qsgd_encode`` and ``::qsgd_decode``
(kernels K2 and K3): the CUDA kernels are ``csrc/qsgd.cu``.  A flat f32
leaf of ``n`` values is read as a zero-padded ``[rows, 128]`` matrix (rows
a multiple of ``lcm(32 // bits, 32)``, :func:`rows_for`; the kernels take 1
to 24 bits); ``32 // bits`` consecutive rows of a
column share a u32 word of levels, 32 rows a word of signs; the scale is
``max(max|x|, 1e-12)``.  Encode rounds ``|x| / scale * level``
stochastically with ``u = (bits >> 8) * 2^-24`` drawn from 32 random bits
per padded element; decode is ``(q * step) * (1 - 2·sign)`` with
``step = scale * fl(1 / level)`` (:func:`decode_step`).

:func:`qsgd_encode` and :func:`qsgd_decode` launch the kernels for CUDA
tensors and raise on anything they do not take; for CPU tensors they
compute :func:`qsgd_encode_plain` and :func:`qsgd_decode_plain`, the same
functions in plain PyTorch.  The random bits: a ``rand_bits`` argument
(``[rows, 128]``, values below 2^32, the TPU interpreter's contract) when
given; otherwise Philox4x32-10 bits drawn in the kernel on the card (key
= seed; element ``(row, column)`` takes word ``row % 4`` of the call whose
counter is ``(row // 4) * 128 + column``, so one call serves four
neighbouring rows of a column: :func:`philox_stream` is that stream in
plain numpy, and :func:`philox_fill` writes it on the card) and bits from
a ``torch.Generator`` seeded with ``seed`` on the CPU.  Words are returned
as int64 tensors holding u32 values (torch has little u32 arithmetic); the
card's kernels write int32 tensors of the same bits.
"""

import ctypes
import math

import numpy as np
import torch

from . import build

LANE = 128
#: the widest level the CUDA kernels take: levels up to 2^24 - 1, the
#: integers f32 holds exactly
KERNEL_MAX_BITS = 24

#: launches of the encode (K2) and decode (K3) kernels since last set to 0
encode_launches = 0
decode_launches = 0

_MASK32 = 0xFFFFFFFF
_bound = None


def rows_for(n: int, bits: int) -> int:
    """Rows of the padded ``[rows, 128]`` matrix: a multiple of the
    level-packing group (``32 // bits``), of the sign group (32) and of 8
    (the JAX package's ``_rows_for``)."""
    group = math.lcm(32 // bits, 32)
    rows = max(1, math.ceil(n / LANE))
    return -(-rows // group) * group


def _library():
    global _bound
    if _bound is None:
        lib = build.load("qsgd")
        p, i, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
        lib.qsgd_partials.argtypes = [i64]
        lib.qsgd_encode.argtypes = [p, i64, i64, u32, i, i, p, p, p, p, p]
        lib.qsgd_encode_with_bits.argtypes = [p, i64, i64, p, i, i, p, p, p, p, p]
        lib.qsgd_encode_per_value.argtypes = [p, i64, i64, u32, i, i, p, p, p, p]
        lib.qsgd_decode.argtypes = [p, p, p, i, i, i64, i64, p, p]
        lib.qsgd_decode_per_value.argtypes = [p, p, p, i, i, i64, p, p]
        lib.qsgd_philox_fill.argtypes = [i64, u32, p, p]
        for fn in (lib.qsgd_partials, lib.qsgd_encode, lib.qsgd_encode_with_bits, lib.qsgd_encode_per_value,
                   lib.qsgd_decode, lib.qsgd_decode_per_value, lib.qsgd_philox_fill):
            fn.restype = ctypes.c_int
        _bound = lib
    return _bound


# ---------------------------------------------------------------- plain
def _pack_rows(values: torch.Tensor, width: int) -> torch.Tensor:
    """``[rows, 128]`` values below ``2^width`` -> ``[rows / lanes, 128]``
    words, row ``g·lanes + j`` at shift ``j·width`` (int64 holding u32)."""
    lanes = 32 // width
    grouped = values.to(torch.int64).reshape(-1, lanes, LANE)
    shifts = (torch.arange(lanes, device=values.device) * width).reshape(1, lanes, 1)
    return (grouped << shifts).sum(dim=1)  # disjoint bit ranges: sum == or


def _unpack_rows(words: torch.Tensor, width: int, rows: int) -> torch.Tensor:
    lanes = 32 // width
    shifts = (torch.arange(lanes, device=words.device) * width).reshape(1, lanes, 1)
    values = (words.to(torch.int64)[:, None, :] >> shifts) & ((1 << width) - 1)
    return values.reshape(rows, LANE)


def qsgd_encode_plain(x: torch.Tensor, level: int, bits: int, rand_bits: torch.Tensor):
    """K2's function: ``(packed [rows/lanes, 128], signs [rows/32, 128],
    scale [1])`` from the flat f32 ``x`` and ``rand_bits [rows, 128]``."""
    n = x.numel()
    rows = rows_for(n, bits)
    padded = torch.zeros(rows * LANE, dtype=torch.float32, device=x.device)
    padded[:n] = x.reshape(-1).to(torch.float32)
    padded = padded.reshape(rows, LANE)
    scale = torch.clamp(padded.abs().max(), min=1e-12)
    normalized = padded.abs() / scale * level
    floor = torch.floor(normalized)
    # the high 24 bits as a uniform in [0, 1); >> of a negative int64 would
    # sign-extend, so mask to 32 bits first
    u = ((rand_bits.to(torch.int64) & _MASK32) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    q = floor + (u < normalized - floor).to(torch.float32)
    packed = _pack_rows(q.to(torch.int64), bits)
    signs = _pack_rows((padded < 0).to(torch.int64), 1)
    return packed, signs, scale.reshape(1)


def level_reciprocal(level: int, device) -> torch.Tensor:
    """``fl(1 / level)``: the f32 reciprocal XLA puts in place of the JAX
    package's division by the constant ``level``."""
    return (torch.tensor(1.0, dtype=torch.float32) / level).to(device)


def decode_step(scale: torch.Tensor, level: int) -> torch.Tensor:
    """``scale * fl(1 / level)`` in f32: the value of one level.  The JAX
    package's decode writes ``q / level * scale``, which XLA evaluates as
    ``q * (scale * fl(1 / level))`` (the reciprocal folded into the scalar
    first); the port computes that, so its decode is bit-equal to the
    reference's."""
    return scale.to(torch.float32) * level_reciprocal(level, scale.device)


def qsgd_decode_plain(packed, signs, scale, level: int, bits: int, n: int) -> torch.Tensor:
    """K3's function: the f32 ``[n]`` leaf from K2's outputs,
    ``(q * step) * (1 - 2·sign)`` with ``step = decode_step(scale, level)``."""
    rows = packed.shape[0] * (32 // bits)
    q = _unpack_rows(packed, bits, rows).to(torch.float32)
    s = _unpack_rows(signs, 1, rows).to(torch.float32)
    out = q * decode_step(scale, level)[0] * (1.0 - 2.0 * s)
    return out.reshape(-1)[:n]


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def philox4x32(counter, seed: int) -> np.ndarray:
    """Philox4x32-10 (Salmon et al., SC'11) of the counters ``counter``
    (an array of values below 2^64, as ``(lo, hi, 0, 0)``) under key
    ``(seed, 0)``: ``[len, 4]`` uint64 arrays of the four output words.
    Each product of two 32-bit words is exact in uint64."""
    counter = np.asarray(counter, dtype=np.uint64).reshape(-1)
    mask = np.uint64(_MASK32)
    c = [counter & mask, counter >> np.uint64(32), np.zeros_like(counter), np.zeros_like(counter)]
    k0, k1 = int(seed) & _MASK32, 0
    for _ in range(10):
        p0, p1 = c[0] * np.uint64(_PHILOX_M[0]), c[2] * np.uint64(_PHILOX_M[1])
        hi0, hi1 = p0 >> np.uint64(32), p1 >> np.uint64(32)
        c = [hi1 ^ c[1] ^ np.uint64(k0), p1 & mask, hi0 ^ c[3] ^ np.uint64(k1), p0 & mask]
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return np.stack(c, axis=1)


def philox_stream(seed: int, rows: int) -> torch.Tensor:
    """The Philox bits :func:`qsgd_encode` draws on the card for ``seed``,
    ``[rows, 128]`` int64 holding u32 values, in plain numpy: element
    ``(row, column)`` takes word ``row % 4`` of counter ``(row // 4) * 128
    + column``, so the bits of an element depend on ``(seed, row * 128 +
    column)`` alone."""
    groups = -(-rows // 4)
    words = philox4x32(np.arange(groups * LANE, dtype=np.uint64), seed)  # [groups * 128, 4]
    stream = words.reshape(groups, LANE, 4).transpose(0, 2, 1).reshape(groups * 4, LANE)[:rows]
    return torch.from_numpy(stream.astype(np.int64))


def generator_bits(seed: int, rows: int, device) -> torch.Tensor:
    """The CPU route's random bits: ``[rows, 128]`` values below 2^32 from
    a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randint(0, 1 << 32, (rows, LANE), generator=gen, dtype=torch.int64, device=device)


# ---------------------------------------------------------------- wrappers
def _check_x(x: torch.Tensor, bits: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"qsgd_encode takes a flat f32 leaf, got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"qsgd runs on cuda or cpu, not {x.device}")
    if x.device.type == "cuda" and (not 1 <= bits <= KERNEL_MAX_BITS or not x.is_contiguous()):
        raise ValueError(f"the qsgd kernels take a contiguous leaf and 1 to {KERNEL_MAX_BITS} bits, got {bits}")


def _u32_view(t: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor of u32 values as contiguous int32 (same bits)."""
    if t.dtype == torch.int32:
        return t.contiguous()
    return (t.to(torch.int64) & _MASK32).to(torch.int32).contiguous()


def qsgd_encode(x: torch.Tensor, seed: int, level: int, bits: int, rand_bits=None):
    """Encode the flat f32 leaf ``x``: ``(packed, signs, scale)``."""
    global encode_launches
    _check_x(x, bits)
    rows = rows_for(x.numel(), bits)
    if rand_bits is not None and tuple(rand_bits.shape) != (rows, LANE):
        raise ValueError(f"rand_bits of shape {tuple(rand_bits.shape)}, want {(rows, LANE)}")
    if x.device.type == "cpu":
        if rand_bits is None:
            rand_bits = generator_bits(seed, rows, x.device)
        return qsgd_encode_plain(x, level, bits, rand_bits)
    lanes = 32 // bits
    lib = _library()
    packed = torch.empty(rows // lanes, LANE, dtype=torch.int32, device=x.device)
    signs = torch.empty(rows // 32, LANE, dtype=torch.int32, device=x.device)
    scale = torch.empty(1, dtype=torch.float32, device=x.device)
    partials = torch.empty(lib.qsgd_partials(x.numel()), dtype=torch.float32, device=x.device)
    outputs = (partials.data_ptr(), packed.data_ptr(), signs.data_ptr(), scale.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if rand_bits is None:
            err = lib.qsgd_encode(x.data_ptr(), x.numel(), rows, int(seed) & _MASK32, level, bits, *outputs, stream)
        else:
            bits_u32 = _u32_view(rand_bits.to(x.device))
            err = lib.qsgd_encode_with_bits(x.data_ptr(), x.numel(), rows, bits_u32.data_ptr(), level, bits,
                                            *outputs, stream)
    if err != 0:
        raise RuntimeError(f"qsgd encode launch failed: CUDA error {err}")
    with build.launch_lock:
        encode_launches += 1
    return packed, signs, scale


def qsgd_decode(packed, signs, scale, level: int, bits: int, n: int) -> torch.Tensor:
    """Decode K2's outputs to the f32 ``[n]`` leaf."""
    global decode_launches
    if packed.device.type == "cpu":
        return qsgd_decode_plain(packed, signs, scale, level, bits, n)
    if packed.device.type != "cuda":
        raise ValueError(f"qsgd runs on cuda or cpu, not {packed.device}")
    if not 1 <= bits <= KERNEL_MAX_BITS:
        raise ValueError(f"the qsgd kernels take 1 to {KERNEL_MAX_BITS} bits, got {bits}")
    rows = packed.shape[0] * (32 // bits)
    if packed.shape[1] != LANE or tuple(signs.shape) != (rows // 32, LANE) or rows * LANE < n:
        raise ValueError(f"packed {tuple(packed.shape)} / signs {tuple(signs.shape)} do not hold {n} values")
    packed, signs = _u32_view(packed), _u32_view(signs)
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=packed.device)
    # the C entry refuses rows that are not rows_for's, more than 2^32 - 1
    # level words (its word index is 32-bit) and a packed, signs or out
    # that is not 16-byte aligned (its loads and stores are 16 bytes)
    with torch.cuda.device(packed.device):
        err = _library().qsgd_decode(
            packed.data_ptr(), signs.data_ptr(), scale.data_ptr(), level, bits, rows, n,
            out.data_ptr(), torch.cuda.current_stream(packed.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qsgd decode launch failed: CUDA error {err}")
    with build.launch_lock:
        decode_launches += 1
    return out


def philox_fill(seed: int, rows: int, device) -> torch.Tensor:
    """The Philox bits :func:`qsgd_encode` draws on the card for ``seed``,
    as ``[rows, 128]`` int64 (CUDA only: a check of the kernel's stream)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("philox_fill runs on the card")
    out = torch.empty(rows, LANE, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = _library().qsgd_philox_fill(
            rows * LANE, int(seed) & _MASK32, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"qsgd philox_fill launch failed: CUDA error {err}")
    return out.to(torch.int64) & _MASK32
