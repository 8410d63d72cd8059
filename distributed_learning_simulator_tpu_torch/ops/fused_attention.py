"""Exact long-sequence attention (the port of ``ops/fused_attention.py``,
TPU kernels K6-K11).

The public surface is the JAX package's: ``q/k/v: [B, T, H, Dh]``,
``kv_mask: [B, T]`` (True = attend) or None, a causal flag, and an lse of
``[B, H, T]``.  :func:`kernel_tier` picks the tier the JAX package would
run on the TPU, with its constants (``MIN_FUSED_T`` floor, VMEM model,
``MAX_STREAM_T``), so both packages route the same shapes; the tier only
decides which TPU kernel id a launch is counted under, because one CUDA
kernel (``csrc/fused_attention.cu``) serves both tiers:

* the forward: K6 (tier ``"fused"``) and K9 (``"stream"``);
* dq: K7 and K10;
* dk, dv: K8 and K11.

:func:`kernel_route` picks, from dtype, Dh and layout alone, which of
four CUDA kernel families serves a call (the same function on each; a
route chosen before the launch, never a fallback):

* ``"wgmma"``: bf16 at Dh 32 or 64 on a layout TMA can describe (16-byte
  aligned bases; nested strides whose byte sizes are multiples of 16).
  The forward, dq and dk/dv run Hopper kernels: TMA tile loads into a
  ring of shared-memory stages with mbarriers, one producer warp, two
  consumer warpgroups on ``wgmma``.  The long-context and causal-LM main
  paths (packed ``[B, T, 3, H, Dh]`` projections) take it;
* ``"mma"``: bf16 at Dh <= 64 on any other layout (a ragged Dh such as
  20, a misaligned stride): ``mma.sync.m16n8k16`` on 64-row tiles;
* ``"tf32x3"``: f32 at Dh 32 or 64 on a layout TMA can describe (the f32
  long-context path's packed projections).  The forward, dq and dk/dv run
  Hopper kernels whose every f32 product is three TF32 products on
  ``wgmma`` (big and small parts: f32 accuracy);
* ``"fma"``: every other f32 call (a ragged Dh, Dh 128, a misaligned
  base or stride) and bf16 at Dh 128, on the f32 FMA units.

All are bound by operations on the H100 (the forward at the main shape,
q/k/v ``[8, 8192, 8, 64]`` bf16: 1.10e12 flop, 1.11 ms at 989 TFLOP/s;
its max pass adds a third product, so its own ceiling is 1.5x that); the
design and what bounds each route are in the CUDA source's header.

Each kernel reads q/k/v as strided views (the packed QKV projection is
never split or padded in memory) and writes ``[B, T, H, Dh]`` directly.
``delta = rowsum(dO * O) - dlse`` is taken in f32 in plain PyTorch outside
the kernels, as the JAX package leaves it to XLA.

:func:`attention_fwd`, :func:`attention_dq` and :func:`attention_dkv`
(and :func:`attention_bwd`, both backward kernels) launch the kernels for
CUDA tensors and raise on what they do not take; for CPU tensors they
compute :func:`attention_fwd_plain` and
:func:`attention_bwd_plain`, the same functions in plain PyTorch with the
same roundings: the forward rounds the unnormalised ``p = exp(s - m)``
(``m`` the row's global maximum) to the input dtype before ``P·V`` and
divides by ``l`` after, as K6 does; the backward rounds ``p`` and
``ds = p·(dP - delta)`` to the input dtype before their products and
multiplies by the scale after.  Invalid keys (masked, past T, or after
the query under ``causal``) score ``-1e30`` and give ``p = 0``, so a row
with no valid key outputs 0 with ``lse = -1e30``.
"""

import ctypes
import math

import torch

from . import build

LANE = 128
MIN_FUSED_T = 1024  # the JAX package's TPU crossover; kept so both route alike
MAX_FUSED_T = 8192
MAX_STREAM_T = 32768
_S_VMEM_BYTES = 2 * 1024 * 1024
_VMEM_BUDGET = 15 * 1024 * 1024
_NEG_INF = -1e30
TIERS = ("fused", "stream")
#: score elements one chunk of the plain version holds ([n, T, T] f32)
_PLAIN_CHUNK_ELEMS = 1 << 26

#: launches per TPU kernel id since last set to 0, counted by tier
launches = {kid: 0 for kid in ("K6", "K7", "K8", "K9", "K10", "K11")}
_FWD_ID = {"fused": "K6", "stream": "K9"}
_DQ_ID = {"fused": "K7", "stream": "K10"}
_DKV_ID = {"fused": "K8", "stream": "K11"}

#: the kernel families, by the code the C entries take
ROUTES = {"fma": 0, "mma": 1, "wgmma": 2, "tf32x3": 3}
#: launches per kernel and route ("fwd/wgmma", ...) since last set to 0
route_launches = {f"{kind}/{route}": 0 for kind in ("fwd", "dq", "dkv") for route in ROUTES}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound = None


# ------------------------------------------------------------------ routing
def _divisor_blk(t_pad: int, cap: int) -> int:
    blk = min(t_pad, max(128, cap))
    while t_pad % blk:
        blk -= 128
    return blk


def _pick_blk(t_pad: int) -> int:
    return _divisor_blk(t_pad, (_S_VMEM_BYTES // (t_pad * 4)) // 128 * 128)


def kernel_tier(t: int, d: int, itemsize: int = 2, _perf_gate: bool = True) -> str | None:
    """The tier the JAX package runs shape (T, Dh) at on the TPU:
    ``"fused"`` (one-level), ``"stream"``, or None (its compiler's path).
    ``_perf_gate`` applies the ``MIN_FUSED_T`` floor."""
    if d > LANE:
        return None
    if _perf_gate and t < MIN_FUSED_T:
        return None
    t_pad = max(128, ((t + 127) // 128) * 128)
    d_pad = 64 if d <= 64 else LANE
    kv_bytes = 2 * t_pad * d_pad * itemsize
    temp_bytes = 3 * _pick_blk(t_pad) * t_pad * 4
    if t <= MAX_FUSED_T and kv_bytes + temp_bytes <= _VMEM_BUDGET:
        return "fused"
    if t <= MAX_STREAM_T:
        return "stream"
    return None


def kernel_eligible(t: int, d: int, itemsize: int = 2) -> bool:
    """True when a kernel tier serves this shape."""
    return kernel_tier(t, d, itemsize) is not None


def eligible(q, mask, dropout_rate: float, deterministic: bool, k=None) -> bool:
    """Can the kernels serve an attention call?  (Probability dropout,
    cross-attention and query- or head-dependent masks cannot.)"""
    if dropout_rate > 0.0 and not deterministic:
        return False
    if q.dim() != 4 or not kernel_eligible(q.shape[1], q.shape[3], q.element_size()):
        return False
    if k is not None and k.shape[1] != q.shape[1]:
        return False
    if mask is not None and (mask.dim() != 4 or mask.shape[-2] != 1 or mask.shape[-3] != 1):
        return False
    return True


def _tma_describable(x, others) -> bool:
    """Can one tensor map ``(Dh, H, T, B)`` describe ``x`` (and each of
    ``others``, which share its shape): 16-byte-aligned bases, and strides
    nested as the map nests them, each a positive multiple of 16 bytes
    (a dimension of size 1 takes any stride)."""
    b, t, h, d = x.shape
    if any(y.data_ptr() % 16 for y in (x, *others)) or x.stride(-1) != 1:
        return False
    sb, st, sh = x.stride(0), x.stride(1), x.stride(2)
    sh = d if h == 1 else sh
    st = sh * h if t == 1 else st
    sb = st * t if b == 1 else sb
    item = x.element_size()
    if any(s <= 0 or (s * item) % 16 for s in (sh, st, sb)):
        return False
    return sh >= d and st >= sh * h and sb >= st * t


def kernel_route(q, k, v, *others) -> str:
    """The kernel family for these operands' layout (``others``: dout,
    contiguous ``[B, T, H, Dh]``): at Dh 32 or 64 where TMA can describe
    q, k, v (sharing their strides) and the others, ``"wgmma"`` for bf16
    and ``"tf32x3"`` for f32; ``"mma"`` for any other bf16 at Dh <= 64;
    ``"fma"`` for every other call.  The forward, dq and dk/dv all run it."""
    d = q.shape[-1]
    tma = (
        d in (32, 64) and k.stride() == q.stride() and v.stride() == q.stride()
        and _tma_describable(q, (k, v)) and all(_tma_describable(x, ()) for x in others)
    )
    if q.dtype == torch.float32:
        return "tf32x3" if tma else "fma"
    if d > 64:
        return "fma"
    return "wgmma" if tma else "mma"


def _named_route(route, kind: str = "fwd"):
    """The route a caller named (checked), or None."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"{kind} route must be one of {tuple(ROUTES)}, got {route!r}")
    return route


# ------------------------------------------------------- plain PyTorch versions
def _head_groups(b: int, h: int, t: int):
    """``(batch, head slice)`` chunks whose ``[n, T, T]`` f32 scores stay
    under ``_PLAIN_CHUNK_ELEMS``."""
    per = max(1, min(h, _PLAIN_CHUNK_ELEMS // (t * t)))
    for bi in range(b):
        for h0 in range(0, h, per):
            yield bi, slice(h0, min(h, h0 + per))


def _valid(kv_mask, bi: int, t: int, causal: bool, device):
    """``[T, T]`` validity (query rows, key columns), or None when every
    key is valid."""
    valid = None
    if kv_mask is not None:
        valid = (kv_mask[bi] != 0)[None, :].expand(t, t)
    if causal:
        tri = torch.ones(t, t, dtype=torch.bool, device=device).tril()
        valid = tri if valid is None else valid & tri
    return valid


def _heads_first(x, bi, hs):
    """``x[bi, :, hs]`` as f32 ``[n, T, Dh]``."""
    return x[bi, :, hs].float().transpose(0, 1)


def attention_fwd_plain(q, k, v, kv_mask=None, causal: bool = False):
    """Plain PyTorch forward: ``(out [B, T, H, Dh], lse [B, H, T] f32)``."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out = torch.empty(b, t, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    for bi, hs in _head_groups(b, h, t):
        qf, kf, vf = (_heads_first(x, bi, hs) for x in (q, k, v))
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        valid = _valid(kv_mask, bi, t, causal, q.device)
        if valid is not None:
            s = torch.where(valid, s, _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        o = torch.matmul(p.to(q.dtype).float(), vf) / l
        out[bi, :, hs] = o.transpose(0, 1).to(q.dtype)
        lse[bi, hs] = (m + torch.log(l))[..., 0]
    return out, lse


def attention_bwd_plain(q, k, v, kv_mask, dout, lse, delta, causal: bool = False):
    """Plain PyTorch backward: ``(dq, dk, dv)``, each ``[B, T, H, Dh]`` in
    the input dtype, from the forward's lse and ``delta`` (f32 ``[B, H, T]``)."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    grads = [torch.empty(b, t, h, d, dtype=q.dtype, device=q.device) for _ in range(3)]
    for bi, hs in _head_groups(b, h, t):
        qf, kf, vf, dof = (_heads_first(x, bi, hs) for x in (q, k, v, dout))
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[bi, hs][..., None])
        valid = _valid(kv_mask, bi, t, causal, q.device)
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = (p * (dp - delta[bi, hs][..., None])).to(q.dtype).float()
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
        dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dof)
        for grad, value in zip(grads, (dq, dk, dv)):
            grad[bi, :, hs] = value.transpose(0, 1).to(q.dtype)
    return tuple(grads)


def attention_delta(dout, out, dlse=None):
    """``rowsum(dO * O) - dlse`` in f32, ``[B, H, T]``: the lse cotangent
    folds into the same ``ds = p·(dP - delta)`` recurrence."""
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


# ------------------------------------------------------------ kernel wrappers
def _library():
    global _bound
    if _bound is None:
        lib = build.load("fused_attention")
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        head = [i, i, p, p, p, ll, ll, ll, p]
        tail = [i, i, i, i, f, i, p]
        lib.fused_attention_fwd.argtypes = head + [p, p] + tail
        lib.fused_attention_dq.argtypes = head + [p, p, p, p] + tail
        lib.fused_attention_dkv.argtypes = head + [p, p, p, p, p] + tail
        for fn in (lib.fused_attention_fwd, lib.fused_attention_dq, lib.fused_attention_dkv):
            fn.restype = i
        _bound = lib
    return _bound


def _check(q, k, v, kv_mask, tier, *rest):
    """Shapes, dtypes, devices and strides the kernels take; returns
    ``(B, T, H, Dh)``.  ``rest`` are ``(name, tensor, shape, dtype)``."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one [B, T, H, Dh] shape, got {q.shape}, {k.shape}, {v.shape}")
    b, t, h, d = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused attention takes f32 or bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < d <= LANE or t <= 0:
        raise ValueError(f"fused attention takes 0 < Dh <= {LANE} and T > 0, got T={t} Dh={d}")
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused attention runs on cuda or cpu, not {q.device}")
    operands = [("k", k), ("v", v)]
    if kv_mask is not None:
        if kv_mask.shape != (b, t) or kv_mask.dtype != torch.float32:
            raise ValueError("kv_mask must be f32 [B, T]")
        operands.append(("kv_mask", kv_mask))
    for name, tensor, shape, dtype in rest:
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got {tensor.dtype} {list(tensor.shape)}")
        operands.append((name, tensor))
    for name, tensor in operands:
        if tensor.device != q.device:
            raise ValueError(f"{name} on {tensor.device} but q on {q.device}")
    if q.device.type == "cuda":
        if q.stride(-1) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
            raise ValueError("q, k, v must share strides with a unit stride over Dh")
        for name, tensor in operands[2:]:
            if not tensor.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    return b, t, h, d


def _head(q, k, v, kv_mask, route):
    """The kernels' common leading arguments."""
    return [
        _DTYPE_CODES[q.dtype], ROUTES[route], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        None if kv_mask is None else kv_mask.data_ptr(),
    ]


def _tail(q, causal):
    b, t, h, d = q.shape
    return [b, t, h, d, 1.0 / math.sqrt(d), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream]


def _raise_on(err: int, what: str, route: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused attention {what} launch ({route} route) failed: CUDA error {err}")


def _count(kid: str, kind: str, route: str) -> None:
    with build.launch_lock:
        launches[kid] += 1
        route_launches[f"{kind}/{route}"] += 1


def attention_fwd(q, k, v, kv_mask=None, causal: bool = False, tier: str = "fused", route=None):
    """Forward: ``(out [B, T, H, Dh], lse [B, H, T] f32)``.  ``kv_mask``
    is f32 ``[B, T]`` (non-zero = attend) or None.  ``route`` overrides
    :func:`kernel_route` (the C entry refuses one the layout cannot take)."""
    b, t, h, d = _check(q, k, v, kv_mask, tier)
    route = _named_route(route) or kernel_route(q, k, v)
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, kv_mask, causal)
    out = torch.empty(b, t, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().fused_attention_fwd(
            *_head(q, k, v, kv_mask, route), out.data_ptr(), lse.data_ptr(), *_tail(q, causal)
        )
    _raise_on(err, "forward", route)
    _count(_FWD_ID[tier], "fwd", route)
    return out, lse


def _bwd_operands(q, dout, lse, delta):
    b, t, h, d = q.shape
    return (
        ("dout", dout, (b, t, h, d), q.dtype),
        ("lse", lse, (b, h, t), torch.float32),
        ("delta", delta, (b, h, t), torch.float32),
    )


def attention_dq(q, k, v, kv_mask, dout, lse, delta, causal: bool = False, tier: str = "fused", route=None):
    """dq ``[B, T, H, Dh]`` from the forward's lse and ``delta``."""
    _check(q, k, v, kv_mask, tier, *_bwd_operands(q, dout, lse, delta))
    route = _named_route(route, "dq") or kernel_route(q, k, v, dout)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, kv_mask, dout, lse, delta, causal)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().fused_attention_dq(
            *_head(q, k, v, kv_mask, route), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *_tail(q, causal),
        )
    _raise_on(err, "dq", route)
    _count(_DQ_ID[tier], "dq", route)
    return dq


def attention_dkv(q, k, v, kv_mask, dout, lse, delta, causal: bool = False, tier: str = "fused", route=None):
    """``(dk, dv)``, each ``[B, T, H, Dh]``."""
    _check(q, k, v, kv_mask, tier, *_bwd_operands(q, dout, lse, delta))
    route = _named_route(route, "dkv") or kernel_route(q, k, v, dout)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, kv_mask, dout, lse, delta, causal)[1:]
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().fused_attention_dkv(
            *_head(q, k, v, kv_mask, route), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *_tail(q, causal),
        )
    _raise_on(err, "dkv", route)
    _count(_DKV_ID[tier], "dkv", route)
    return dk, dv


def attention_bwd(q, k, v, kv_mask, dout, lse, delta, causal: bool = False, tier: str = "fused"):
    """``(dq, dk, dv)``: the dq and dkv kernels for CUDA tensors; for CPU
    tensors the plain backward, once for all three."""
    if q.device.type == "cpu":
        _check(q, k, v, kv_mask, tier, *_bwd_operands(q, dout, lse, delta))
        return attention_bwd_plain(q, k, v, kv_mask, dout, lse, delta, causal)
    args = (q, k, v, kv_mask, dout, lse, delta, causal, tier)
    return (attention_dq(*args), *attention_dkv(*args))


class FusedAttentionFunction(torch.autograd.Function):
    """``(out, lse)`` from the forward kernel, with the dq and dkv kernels
    as the gradient of both (the JAX package's ``_attend`` and
    ``_attend_lse`` custom_vjps): the lse cotangent folds into ``delta``,
    and an unused lse contributes a zero cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, tier):
        out, lse = attention_fwd(q, k, v, kv_mask, causal, tier)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.tier = causal, tier
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(dout, out, dlse)
        dq, dk, dv = attention_bwd(q, k, v, kv_mask, dout, lse, delta, ctx.causal, ctx.tier)
        return dq, dk, dv, None, None, None


def _prepare(q, k, v, kv_mask, tier):
    """Tier resolution, the f32 key mask, and one stride set for q/k/v."""
    b, t, h, d = q.shape
    if tier is None:
        tier = kernel_tier(t, d, q.element_size(), _perf_gate=False)
    if tier not in TIERS:
        raise ValueError(f"no kernel tier serves T={t} Dh={d}")
    if q.stride(-1) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    return tier, q, k, v, kv_mask


def fused_attention(q, k, v, kv_mask=None, causal: bool = False, tier=None):
    """Exact attention over ``q/k/v: [B, T, H, Dh]`` with an optional
    ``[B, T]`` key-padding mask (True = attend); returns ``[B, T, H, Dh]``.
    Callers gate with :func:`kernel_tier`; ``tier`` overrides the choice."""
    tier, q, k, v, kv_mask = _prepare(q, k, v, kv_mask, tier)
    return FusedAttentionFunction.apply(q, k, v, kv_mask, causal, tier)[0]


def fused_attention_lse(q, k, v, kv_mask=None, causal: bool = False, tier=None):
    """Like :func:`fused_attention` but also returns the per-row
    log-sum-exp ``[B, H, T]`` (the merge currency of ring attention),
    differentiable in both outputs."""
    tier, q, k, v, kv_mask = _prepare(q, k, v, kv_mask, tier)
    return FusedAttentionFunction.apply(q, k, v, kv_mask, causal, tier)
