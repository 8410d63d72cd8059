"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper computes its kernel's plain PyTorch version (the
CUDA kernels themselves are held to those plain versions on the card by
``chip_smoke.py``).  Inputs are made with numpy from a seed and handed to
both packages.

* K1 ``weighted_accum``: the JAX kernel runs in interpret mode off the TPU.
* K4/K5 ``short_attention``: the JAX kernels run under the Pallas
  interpreter (``DLS_TPU_FUSED_ATTN=interpret``, as
  ``tests/test_short_attention.py`` does); the backward is compared
  against ``jax.vjp`` of the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.ops import pallas_kernels as jpk
from distributed_learning_simulator_tpu.ops import short_attention as jsa
from distributed_learning_simulator_tpu_torch.ops import short_attention as tsa
from distributed_learning_simulator_tpu_torch.ops import weighted_accum as twa


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DLS_TPU_FUSED_ATTN", "interpret")


def _bf16_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------- K1
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,n", [(2, 1000), (3, 70001), (5, 128)])
def test_weighted_accum_plain_matches_jax(dtype, c, n):
    rng = np.random.default_rng(c * 7 + n)
    x = rng.normal(size=(c, n)).astype(np.float32)
    w = (rng.random(c) * 512).astype(np.float32)
    x_t = torch.from_numpy(x).to(getattr(torch, dtype))
    x_j = jnp.asarray(_bf16_numpy(x_t))  # the same (rounded) row values
    if dtype == "bfloat16":
        x_j = x_j.astype(jnp.bfloat16)
    out = twa.weighted_accum(x_t, torch.from_numpy(w))
    ref = np.asarray(jpk.weighted_accum(x_j, jnp.asarray(w)))
    assert out.dtype == torch.float32 and out.shape == (n,)
    # both accumulate exact row values in f32, client by client; the sums
    # of c terms of magnitude <= ~2000 agree to a few f32 ulps
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-3)
    assert twa.launches == 0  # the CPU path launches nothing


def test_weighted_accum_strided_rows():
    """A row-strided view (the session's chunk buffer slices) is read as is."""
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    x = buf[:, :33]
    w = torch.tensor([1.0, 2.0, 3.0])
    np.testing.assert_allclose(
        twa.weighted_accum(x, w).numpy(),
        (x * w[:, None]).sum(0).numpy(),
        rtol=1e-6,
    )


@pytest.mark.parametrize(
    "x,w,exc",
    [
        (torch.zeros(2, 4, dtype=torch.float16), torch.ones(2), TypeError),
        (torch.zeros(2, 4), torch.ones(2, dtype=torch.float64), TypeError),
        (torch.zeros(2, 4), torch.ones(3), ValueError),
        (torch.zeros(8), torch.ones(8), ValueError),
        (torch.zeros(2, 4, device="meta"), torch.ones(2, device="meta"), ValueError),
    ],
)
def test_weighted_accum_rejects(x, w, exc):
    with pytest.raises(exc):
        twa.weighted_accum(x, w)


# ---------------------------------------------------------------- K4 / K5
CASES = [
    (4, 64, 6, 64),  # ViT-small's shape
    (3, 50, 6, 64),  # S not a multiple of 16: the JAX side pads, the port does not
    (2, 128, 2, 128),  # Dh = 128
]


def _inputs(b, s, h, dh, with_mask, seed):
    rng = np.random.default_rng(seed)
    d = h * dh
    qkv = rng.normal(size=(b, s, 3 * d)).astype(np.float32)
    dout = rng.normal(size=(b, s, d)).astype(np.float32)
    mask = None
    if with_mask:
        mask = rng.integers(0, 2, (b, s)).astype(np.float32)
        mask[:, 0] = 1  # no all-masked rows
    return qkv, dout, mask


def _jax_fwd_vjp(qkv, dout, mask, h, dtype):
    q = jnp.asarray(qkv).astype(dtype)
    m = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda t: jsa.short_attention(t, h, kv_mask=m), q)
    (dqkv,) = vjp(jnp.asarray(dout).astype(dtype))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dqkv.astype(jnp.float32))


@pytest.mark.parametrize("b,s,h,dh", CASES)
@pytest.mark.parametrize("with_mask", [False, True])
def test_short_attention_plain_matches_jax_f32(b, s, h, dh, with_mask):
    qkv, dout, mask = _inputs(b, s, h, dh, with_mask, seed=s + dh)
    mask_t = None if mask is None else torch.from_numpy(mask)
    out, lse = tsa.short_attention_fwd(torch.from_numpy(qkv), h, mask_t)
    dqkv = tsa.short_attention_bwd(
        torch.from_numpy(qkv), torch.from_numpy(dout), lse, h, mask_t
    )
    ref_out, ref_dqkv = _jax_fwd_vjp(qkv, dout, mask, h, jnp.float32)
    # f32 end to end; the two differ only in summation order and in
    # exp(s - lse) versus exp(s - max) / sum
    np.testing.assert_allclose(out.numpy(), ref_out, atol=3e-6)
    np.testing.assert_allclose(dqkv.numpy(), ref_dqkv, atol=2e-5)
    assert tsa.fwd_launches == 0 and tsa.bwd_launches == 0


@pytest.mark.parametrize("b,s,h,dh", CASES[:2])
def test_short_attention_plain_matches_jax_bf16(b, s, h, dh):
    qkv, dout, mask = _inputs(b, s, h, dh, True, seed=11)
    qkv_t = torch.from_numpy(qkv).to(torch.bfloat16)
    dout_t = torch.from_numpy(dout).to(torch.bfloat16)
    out, lse = tsa.short_attention_fwd(qkv_t, h, torch.from_numpy(mask))
    dqkv = tsa.short_attention_bwd(qkv_t, dout_t, lse, h, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16 and dqkv.dtype == torch.bfloat16
    ref_out, ref_dqkv = _jax_fwd_vjp(
        _bf16_numpy(qkv_t), _bf16_numpy(dout_t), mask, h, jnp.bfloat16
    )
    # both round p (and dS) to bf16 before the products and the outputs to
    # bf16; a probability on either side of a rounding boundary moves an
    # output by about one bf16 ulp of values of size ~1-4
    np.testing.assert_allclose(_bf16_numpy(out), ref_out, atol=3e-2)
    np.testing.assert_allclose(_bf16_numpy(dqkv), ref_dqkv, atol=6e-2)


def _reference(qkv, h, kv_mask=None):
    b, s, width = qkv.shape
    d = width // 3
    dh = d // h
    q, k, v = (t.reshape(b, s, h, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    logits = q @ k.transpose(-1, -2) * dh**-0.5
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :] > 0, logits, -1e30)
    out = torch.softmax(logits, -1) @ v
    return out.transpose(1, 2).reshape(b, s, d)


@pytest.mark.parametrize("with_mask", [False, True])
def test_short_attention_autograd_function_on_cpu(with_mask):
    """The ``autograd.Function`` joins the forward and the backward: its
    gradient equals autograd through a plain softmax attention."""
    qkv, dout, mask = _inputs(2, 64, 2, 64, with_mask, seed=3)
    mask_t = None if mask is None else torch.from_numpy(mask)
    x1 = torch.from_numpy(qkv).requires_grad_(True)
    x2 = torch.from_numpy(qkv).requires_grad_(True)
    out1 = tsa.short_attention(x1, 2, kv_mask=mask_t)
    out2 = _reference(x2, 2, mask_t)
    (out1 * torch.from_numpy(dout)).sum().backward()
    (out2 * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(out1.detach().numpy(), out2.detach().numpy(), atol=3e-6)
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), atol=2e-5)


@pytest.mark.parametrize(
    "shape,heads,exc",
    [
        ((2, 64, 3 * 96), 2, ValueError),  # Dh = 48
        ((2, 1100, 3 * 128), 2, ValueError),  # S > 1024
        ((2, 64, 100), 2, ValueError),  # not 3·H·Dh
    ],
)
def test_short_attention_rejects(shape, heads, exc):
    with pytest.raises(exc):
        tsa.short_attention_fwd(torch.zeros(shape), heads)


def test_short_attention_rejects_float16():
    with pytest.raises(TypeError):
        tsa.short_attention_fwd(torch.zeros(2, 64, 384, dtype=torch.float16), 2)


# ------------------------------------------------------- K4 forward routes
def _packed_qkv(b, s, h, dh, dtype, offset=0, extra=0):
    """A ``[B, S, 3·H·Dh]`` projection; ``offset`` elements shift its base
    (a contiguous but misaligned view), ``extra`` pad each row (a strided
    view)."""
    width = 3 * h * dh
    flat = torch.zeros(b * s * (width + extra) + offset, dtype=dtype)
    return flat[offset:].view(b, s, width + extra)[..., :width]


@pytest.mark.parametrize(
    "shape,dtype,offset,extra,route",
    [
        # the ViT-small and vit_base paths: bf16, Dh 64, contiguous
        ((4, 64, 6, 64), torch.bfloat16, 0, 0, "wgmma"),
        ((2, 64, 12, 64), torch.bfloat16, 0, 0, "wgmma"),
        ((2, 50, 3, 64), torch.bfloat16, 0, 0, "wgmma"),  # S 50, an odd head count
        ((1, 1024, 2, 64), torch.bfloat16, 0, 0, "wgmma"),  # the two-pass walk
        ((2, 64, 6, 64), torch.float32, 0, 0, "fma"),  # f32 products stay f32
        ((2, 64, 2, 128), torch.bfloat16, 0, 0, "fma"),  # Dh 128
        ((2, 64, 6, 64), torch.bfloat16, 1, 0, "fma"),  # base off by 2 bytes
        ((2, 64, 6, 64), torch.bfloat16, 0, 8, "fma"),  # rows on a wider stride
    ],
)
def test_short_fwd_route_follows_the_layout_rule(shape, dtype, offset, extra, route):
    qkv = _packed_qkv(*shape, dtype, offset, extra)
    assert tsa.fwd_route(qkv, shape[2]) == route


@pytest.mark.parametrize(
    "shape,offset,extra,describable",
    [
        ((4, 64, 6, 64), 0, 0, True),
        ((1, 1, 1, 64), 0, 0, True),  # one row, one head
        ((2, 64, 6, 64), 1, 0, False),
        ((2, 64, 6, 64), 8, 0, True),  # 16 bytes off: aligned
        ((2, 64, 6, 64), 0, 8, False),
        ((2, 64, 1, 4), 0, 0, False),  # a 24-byte row
        ((2, 64, 1, 8), 0, 0, True),  # 48-byte rows, 16-byte blocks
    ],
)
def test_short_tma_describable_on_the_packed_view(shape, offset, extra, describable):
    """Three ``(Dh, H, S, B)`` maps over ``[B, S, 3, H, Dh]`` need contiguous
    rows, a 16-byte-aligned base, and rows and Q/K/V blocks whose byte
    sizes are multiples of 16."""
    qkv = _packed_qkv(*shape, torch.bfloat16, offset, extra)
    assert tsa._tma_describable(qkv) is describable


def test_short_fwd_named_routes_compute_the_same_function_on_the_cpu():
    """On CPU tensors every route is the plain version; an unknown route is
    refused before any work."""
    qkv, _, mask = _inputs(2, 50, 2, 64, True, seed=9)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    m = torch.from_numpy(mask)
    want = tsa.short_attention_fwd(x, 2, m)
    for route in tsa.ROUTES:
        got = tsa._fwd(x, 2, m, route)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="route"):
        tsa._fwd(x, 2, m, "tensor_core")
    assert tsa.route_launches == dict.fromkeys(tsa.route_launches, 0)  # the CPU path launches nothing


# ------------------------------------------------------ K5 backward routes
@pytest.mark.parametrize(
    "shape,dtype,offset,extra,route",
    [
        # the ViT-small and vit_base paths: bf16, Dh 64, S <= 64, contiguous
        ((4, 64, 6, 64), torch.bfloat16, 0, 0, "wgmma"),
        ((2, 64, 12, 64), torch.bfloat16, 0, 0, "wgmma"),
        ((2, 50, 3, 64), torch.bfloat16, 0, 0, "wgmma"),  # S 50, an odd head count
        ((2, 65, 6, 64), torch.bfloat16, 0, 0, "fma"),  # S past one tile
        ((1, 1024, 2, 64), torch.bfloat16, 0, 0, "fma"),
        ((2, 64, 6, 64), torch.float32, 0, 0, "fma"),  # f32 products stay f32
        ((2, 64, 2, 128), torch.bfloat16, 0, 0, "fma"),  # Dh 128
        ((2, 64, 6, 64), torch.bfloat16, 1, 0, "fma"),  # base off by 2 bytes
        ((2, 64, 6, 64), torch.bfloat16, 0, 8, "fma"),  # rows on a wider stride
    ],
)
def test_short_bwd_route_follows_the_layout_rule(shape, dtype, offset, extra, route):
    qkv = _packed_qkv(*shape, dtype, offset, extra)
    assert tsa.bwd_route(qkv, shape[2]) == route


@pytest.mark.parametrize("offset,route", [(0, "wgmma"), (8, "wgmma"), (1, "fma")])
def test_short_bwd_route_needs_a_16_byte_aligned_dout(offset, route):
    """The fourth tensor map reads dO from its base: 16 bytes off is
    aligned, 2 bytes off is not."""
    b, s, h, dh = 2, 64, 6, 64
    qkv = _packed_qkv(b, s, h, dh, torch.bfloat16)
    dout = torch.zeros(b * s * h * dh + offset, dtype=torch.bfloat16)[offset:].view(b, s, h * dh)
    assert tsa.bwd_route(qkv, h, dout) == route


def test_short_bwd_named_routes_compute_the_same_function_on_the_cpu():
    """On CPU tensors every backward route is the plain version; an unknown
    route is refused before any work."""
    qkv, dout, mask = _inputs(2, 50, 2, 64, True, seed=10)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    do = torch.from_numpy(dout).to(torch.bfloat16)
    m = torch.from_numpy(mask)
    _, lse = tsa.short_attention_fwd(x, 2, m)
    want = tsa.short_attention_bwd_plain(x, do, lse, 2, m)
    assert torch.equal(tsa.short_attention_bwd(x, do, lse, 2, m), want)
    for route in tsa.ROUTES:
        assert torch.equal(tsa._bwd(x, do, lse, 2, m, route), want)
    with pytest.raises(ValueError, match="route"):
        tsa._bwd(x, do, lse, 2, m, "tensor_core")
    assert tsa.route_launches == dict.fromkeys(tsa.route_launches, 0)  # the CPU path launches nothing
    assert "bwd/wgmma" in tsa.route_launches


def _relative_mismatch(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """``(max |got - want| / max |want|, rms(got - want) / rms(want))``."""
    err = got.astype(np.float64) - want.astype(np.float64)
    return (
        float(np.abs(err).max() / np.abs(want).max()),
        float(np.sqrt(np.mean(err**2)) / np.sqrt(np.mean(want.astype(np.float64) ** 2))),
    )


@pytest.mark.parametrize("b,s,h", [(2, 64, 6), (2, 64, 12)])
def test_short_bwd_plain_matches_jax_short_bwd_bf16(b, s, h):
    """The plain backward against the JAX ``_short_bwd`` (its Pallas
    ``_bwd_kernel`` under the interpreter) in bf16 at the main paths' head
    layouts: ViT-small's 6 heads and vit_base's 12, Dh 64, S 64, no mask.
    Tolerance on each of the dq, dk and dv blocks, relative to the JAX
    block: max 2^-6 of its largest magnitude, RMS 1e-3 of its RMS (the
    tolerance the CUDA kernel is held to on the card).  Both round p and dS
    to bf16 at the same points; the JAX kernel forms p as exp(s - m) / l,
    the port as exp(s - lse), so a value at a bf16 rounding boundary can
    land on either side (one bf16 ulp, 2^-8 of a value)."""
    qkv, dout, _ = _inputs(b, s, h, 64, False, seed=21 + h)
    qkv_t = torch.from_numpy(qkv).to(torch.bfloat16)
    dout_t = torch.from_numpy(dout).to(torch.bfloat16)
    _, lse = tsa.short_attention_fwd(qkv_t, h)
    got = _bf16_numpy(tsa.short_attention_bwd_plain(qkv_t, dout_t, lse, h))
    qkv_j = jnp.asarray(_bf16_numpy(qkv_t)).astype(jnp.bfloat16)
    dout_j = jnp.asarray(_bf16_numpy(dout_t)).astype(jnp.bfloat16)
    dqkv_j, _ = jsa._short_bwd(h, s, (qkv_j, None), dout_j)
    want = np.asarray(dqkv_j.astype(jnp.float32))
    d = h * 64
    for i, name in enumerate(("dq", "dk", "dv")):
        rel_max, rel_rms = _relative_mismatch(got[..., i * d : (i + 1) * d], want[..., i * d : (i + 1) * d])
        assert rel_max <= 2.0**-6 and rel_rms <= 1e-3, (name, rel_max, rel_rms)
