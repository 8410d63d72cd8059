"""Short-sequence attention in the packed-QKV projection layout.

The port of ``ops/short_attention.py`` (kernels K4 and K5): the CUDA
kernels are ``csrc/short_attention.cu``.  The input is the packed
``[B, S, 3·H·Dh]`` output of one QKV projection (Q rows, then K, then V,
heads side by side); the output is ``[B, S, H·Dh]``, ready for the output
projection.  Scores and softmax are f32, the probabilities are rounded to
the input dtype before ``P·V`` (as the TPU kernel casts ``p``), keys with
``kv_mask <= 0`` score ``-1e30``.

:func:`fwd_route` picks the forward's kernel from dtype, Dh and layout
alone (a route chosen before the launch, never a fallback): ``"wgmma"``,
the Hopper kernel (TMA loads of the packed rows, ``wgmma`` products, one
pass at S <= 64), for bf16 at Dh 64 on a layout three tensor maps
describe (:func:`_tma_describable`): the ViT and fed_obd_sq paths;
``"fma"``, the first kernel (products on the f32 FMA units), for f32,
Dh 128 and any other layout.  :func:`bwd_route` picks the backward's the
same way: ``"wgmma"`` (one launch: S, dP, dQ, dV and dK on ``wgmma``,
delta in registers) for bf16 at Dh 64 and ``S <= 64`` on such a layout,
``"fma"`` (two launches and a delta scratch) otherwise.
``route_launches`` counts launches per kernel and route.

:func:`short_attention_fwd` and :func:`short_attention_bwd` launch the
kernels for CUDA tensors and raise on anything they do not take; for CPU
tensors they compute :func:`short_attention_fwd_plain` and
:func:`short_attention_bwd_plain`, the same functions in plain PyTorch.
:class:`ShortAttentionFunction` joins the two for autograd.  The forward
saves the per-row log-sum-exp; the backward forms
``delta = rowsum(dP ⊙ P)`` as the TPU kernel does.
"""

import ctypes

import torch

from . import build

_NEG_INF = -1e30
MAX_SHORT_T = 1024  # hand-off point to the long-sequence kernels
#: the JAX gate's working-set bound, kept so both packages route the same
#: shapes to this kernel
_VMEM_BUDGET = 13 * 1024 * 1024

#: launches of the forward / backward kernels since last set to 0
fwd_launches = 0
bwd_launches = 0

#: the kernels of the forward and of the backward, by the code the C
#: entries take
ROUTES = {"fma": 0, "wgmma": 1}
#: launches per kernel and route ("fwd/wgmma", ...) since last set to 0
route_launches = {"fwd/fma": 0, "fwd/wgmma": 0, "bwd/fma": 0, "bwd/wgmma": 0}
#: the longest sequence the Hopper backward takes (one 64-row tile)
WGMMA_BWD_MAX_S = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_bound = None


def short_eligible(s: int, d_model: int, num_heads: int, itemsize: int = 2) -> bool:
    """Does this kernel serve a ``[B, S, 3·d_model]`` packed projection?
    The JAX package's shape rules: head dim 64 or 128, ``d_model`` a
    multiple of 128, ``S <= 1024`` and its working-set bound."""
    if d_model % num_heads:
        return False
    dh = d_model // num_heads
    if dh not in (64, 128) or d_model % 128:
        return False
    if s > MAX_SHORT_T:
        return False
    rows = max((s + 15) // 16 * 16, 128)
    working = 4 * d_model * rows * itemsize + 4 * rows * rows * 4
    return working <= _VMEM_BUDGET


def _library():
    global _bound
    if _bound is None:
        lib = build.load("short_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.short_attention_fwd.argtypes = [i, i, p, p, p, p, i, i, i, i, p]
        lib.short_attention_fwd.restype = i
        lib.short_attention_bwd.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, p]
        lib.short_attention_bwd.restype = i
        _bound = lib
    return _bound


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """f32 ``q, k, v`` as ``[B, H, S, Dh]`` views of the packed rows."""
    b, s, width = qkv.shape
    dh = width // 3 // num_heads
    x = qkv.float().view(b, s, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _masked_logits(q, k, kv_mask, scale):
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :] > 0, logits, _NEG_INF)
    return logits


def short_attention_fwd_plain(qkv, num_heads: int, kv_mask=None):
    """Plain PyTorch forward: ``(out [B, S, H·Dh], lse [B, H, S] f32)``."""
    b, s, width = qkv.shape
    dh = width // 3 // num_heads
    q, k, v = _split_heads(qkv, num_heads)
    logits = _masked_logits(q, k, kv_mask, dh**-0.5)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None]).to(qkv.dtype).float()
    out = torch.matmul(p, v).permute(0, 2, 1, 3).reshape(b, s, width // 3)
    return out.to(qkv.dtype), lse


def short_attention_bwd_plain(qkv, dout, lse, num_heads: int, kv_mask=None):
    """Plain PyTorch backward: ``d(qkv)`` in the packed layout."""
    b, s, width = qkv.shape
    dh = width // 3 // num_heads
    scale = dh**-0.5
    q, k, v = _split_heads(qkv, num_heads)
    do = dout.float().view(b, s, num_heads, dh).permute(0, 2, 1, 3)
    p = torch.exp(_masked_logits(q, k, kv_mask, scale) - lse[..., None])
    dv = torch.matmul(p.to(qkv.dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    ds = (ds * scale).to(qkv.dtype).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv], dim=0).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, s, width).to(qkv.dtype)


def _check(qkv, num_heads, kv_mask, dout=None, lse=None):
    if qkv.dim() != 3 or qkv.shape[2] % 3 or (qkv.shape[2] // 3) % num_heads:
        raise ValueError(f"qkv must be [B, S, 3·H·Dh], got {tuple(qkv.shape)}")
    b, s, width = qkv.shape
    dh = width // 3 // num_heads
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"short_attention takes f32 or bf16, got {qkv.dtype}")
    if dh not in (64, 128):
        raise ValueError(f"short_attention takes head dim 64 or 128, got {dh}")
    if not 0 < s <= MAX_SHORT_T:
        raise ValueError(f"short_attention takes 0 < S <= {MAX_SHORT_T}, got {s}")
    operands = [("qkv", qkv)]
    if kv_mask is not None:
        if kv_mask.shape != (b, s) or kv_mask.dtype != torch.float32:
            raise ValueError("kv_mask must be f32 [B, S]")
        operands.append(("kv_mask", kv_mask))
    if dout is not None:
        if dout.shape != (b, s, width // 3) or dout.dtype != qkv.dtype:
            raise ValueError("dout must match the forward output")
        operands.append(("dout", dout))
    if lse is not None:
        if lse.shape != (b, num_heads, s) or lse.dtype != torch.float32:
            raise ValueError("lse must be f32 [B, H, S]")
        operands.append(("lse", lse))
    for name, t in operands:
        if t.device != qkv.device:
            raise ValueError(f"{name} on {t.device} but qkv on {qkv.device}")
        if qkv.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qkv.device.type not in ("cuda", "cpu"):
        raise ValueError(f"short_attention runs on cuda or cpu, not {qkv.device}")
    return b, s, dh


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tma_describable(qkv) -> bool:
    """Can three 4-d tensor maps ``(Dh, H, S, B)`` describe the Q, K and V
    blocks of ``qkv`` viewed as ``[B, S, 3, H, Dh]``: contiguous rows on a
    16-byte-aligned base, a row (``3·H·Dh`` values) and each block's offset
    in it (``H·Dh``) multiples of 16 bytes."""
    width = qkv.shape[2]
    item = qkv.element_size()
    return (
        qkv.is_contiguous()
        and qkv.data_ptr() % 16 == 0
        and (width * item) % 16 == 0
        and (width // 3 * item) % 16 == 0
    )


def fwd_route(qkv, num_heads: int) -> str:
    """The forward's kernel for this packed projection: ``"wgmma"`` for
    bf16 at Dh 64 where :func:`_tma_describable`, else ``"fma"``."""
    dh = qkv.shape[2] // 3 // num_heads
    if qkv.dtype == torch.bfloat16 and dh == 64 and _tma_describable(qkv):
        return "wgmma"
    return "fma"


def bwd_route(qkv, num_heads: int, dout=None) -> str:
    """The backward's kernel for this packed projection: ``"wgmma"`` for
    bf16 at Dh 64 and ``S <= 64`` where :func:`_tma_describable` (and
    ``dout``, if given, starts on a 16-byte boundary), else ``"fma"``."""
    dout_aligned = dout is None or dout.data_ptr() % 16 == 0
    if fwd_route(qkv, num_heads) == "wgmma" and qkv.shape[1] <= WGMMA_BWD_MAX_S and dout_aligned:
        return "wgmma"
    return "fma"


def _named_route(route):
    """``route`` if it names a kernel or is None; anything else is refused
    before any work."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {tuple(ROUTES)}, got {route!r}")
    return route


def short_attention_fwd(qkv, num_heads: int, kv_mask=None):
    """Forward over the packed projection: ``(out, lse)``."""
    return _fwd(qkv, num_heads, kv_mask, None)


def _fwd(qkv, num_heads: int, kv_mask, route):
    """:func:`short_attention_fwd` on ``route`` (None: :func:`fwd_route`);
    the C entry refuses a route the dtype, Dh or layout cannot take."""
    global fwd_launches
    b, s, dh = _check(qkv, num_heads, kv_mask)
    route = _named_route(route) or fwd_route(qkv, num_heads)
    if qkv.device.type == "cpu":
        return short_attention_fwd_plain(qkv, num_heads, kv_mask)
    out = torch.empty(b, s, num_heads * dh, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(b, num_heads, s, dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _library().short_attention_fwd(
            _DTYPE_CODES[qkv.dtype],
            ROUTES[route],
            qkv.data_ptr(),
            _ptr(kv_mask),
            out.data_ptr(),
            lse.data_ptr(),
            b,
            s,
            num_heads,
            dh,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"short_attention forward launch ({route} route) failed: CUDA error {err}")
    with build.launch_lock:
        fwd_launches += 1
        route_launches[f"fwd/{route}"] += 1
    return out, lse


def short_attention_bwd(qkv, dout, lse, num_heads: int, kv_mask=None):
    """Backward: ``d(qkv)`` from the forward's input, ``lse`` and ``dout``."""
    return _bwd(qkv, dout, lse, num_heads, kv_mask, None)


def _bwd(qkv, dout, lse, num_heads: int, kv_mask, route):
    """:func:`short_attention_bwd` on ``route`` (None: :func:`bwd_route`);
    the C entry refuses a route the dtype, Dh, S or layout cannot take."""
    global bwd_launches
    b, s, dh = _check(qkv, num_heads, kv_mask, dout, lse)
    route = _named_route(route) or bwd_route(qkv, num_heads, dout)
    if qkv.device.type == "cpu":
        return short_attention_bwd_plain(qkv, dout, lse, num_heads, kv_mask)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse) if route == "fma" else None
    with torch.cuda.device(qkv.device):
        err = _library().short_attention_bwd(
            _DTYPE_CODES[qkv.dtype],
            ROUTES[route],
            qkv.data_ptr(),
            _ptr(kv_mask),
            dout.data_ptr(),
            lse.data_ptr(),
            _ptr(delta),
            dqkv.data_ptr(),
            b,
            s,
            num_heads,
            dh,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"short_attention backward launch ({route} route) failed: CUDA error {err}")
    with build.launch_lock:
        bwd_launches += 1
        route_launches[f"bwd/{route}"] += 1
    return dqkv


class ShortAttentionFunction(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient (the
    TPU package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, qkv, kv_mask, num_heads):
        out, lse = short_attention_fwd(qkv, num_heads, kv_mask)
        ctx.save_for_backward(qkv, kv_mask, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, kv_mask, lse = ctx.saved_tensors
        dqkv = short_attention_bwd(
            qkv, dout.contiguous(), lse, ctx.num_heads, kv_mask
        )
        return dqkv, None, None


def short_attention(qkv, num_heads: int, kv_mask=None):
    """``softmax(QKᵀ·Dh^-0.5)V`` over a packed ``[B, S, 3·H·Dh]``
    projection, returning ``[B, S, H·Dh]``.  ``kv_mask``: optional
    ``[B, S]`` key-padding mask (> 0 = attend).  Callers gate with
    :func:`short_eligible`."""
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    return ShortAttentionFunction.apply(qkv.contiguous(), kv_mask, num_heads)


__all__ = [
    "MAX_SHORT_T",
    "ROUTES",
    "ShortAttentionFunction",
    "WGMMA_BWD_MAX_S",
    "bwd_route",
    "fwd_route",
    "short_attention",
    "short_attention_bwd",
    "short_attention_bwd_plain",
    "short_attention_fwd",
    "short_attention_fwd_plain",
    "short_eligible",
]
