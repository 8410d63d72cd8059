"""The port's long-sequence attention (K6-K11) against the JAX package's.

On the CPU the port's wrappers compute the kernels' plain PyTorch versions
(``chip_smoke.py`` holds the CUDA kernels to those on the card).  The JAX
side runs its Pallas kernels under the interpreter
(``DLS_TPU_FUSED_ATTN=interpret``, as ``tests/test_fused_attention.py``
does).  Inputs are numpy arrays made from a seed and handed to both.

Tolerances: f32 ``atol 2e-5`` (the JAX kernel tests' own; summation order
only).  bf16: both sides round ``p`` and ``ds`` to bf16 before their
products and the outputs to bf16, so a value that lands on a rounding
boundary in one and not the other moves an output by a few bf16 ulps;
the bound is 4 ulps (``2^-5``) of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.ops import fused_attention as jfa
from distributed_learning_simulator_tpu_torch.ops import fused_attention as tfa

BF16_REL = 2.0**-5  # 4 bf16 ulps (2^-7 at magnitudes 1-2)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DLS_TPU_FUSED_ATTN", "interpret")


def _inputs(b, t, h, d, seed, mask_p=0.25):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(4))
    mask = rng.random((b, t)) > mask_p
    return q, k, v, do, mask


def _jax_run(q, k, v, do, mask, causal, tier, dtype, dlse=None):
    """JAX forward (out, lse) and the vjp's (dq, dk, dv), as f32 numpy."""
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    m = None if mask is None else jnp.asarray(mask)

    def fn(q, k, v):
        return jfa.fused_attention_lse(q, k, v, kv_mask=m, causal=causal, tier=tier)

    (out, lse), vjp = jax.vjp(fn, *args)
    cot_lse = jnp.zeros_like(lse) if dlse is None else jnp.asarray(dlse)
    grads = vjp((jnp.asarray(do).astype(dtype), cot_lse))
    as_np = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return as_np(out), np.asarray(lse), [as_np(g) for g in grads]


def _torch_run(q, k, v, do, mask, causal, tier, dtype, dlse=None):
    """The port's public functions through autograd on the CPU."""
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    out, lse = tfa.fused_attention_lse(*leaves, kv_mask=m, causal=causal, tier=tier)
    cot = [torch.from_numpy(do).to(dtype)]
    outputs = [out]
    if dlse is not None:
        outputs.append(lse)
        cot.append(torch.from_numpy(dlse))
    torch.autograd.backward(outputs, cot)
    return (
        out.detach().float().numpy(),
        lse.detach().numpy(),
        [x.grad.float().numpy() for x in leaves],
    )


def _assert_close(got, want, dtype, name):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_REL * float(np.abs(want).max()), err_msg=name)


def _compare(q, k, v, do, mask, causal, tier, dtype, dlse=None):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if dtype == torch.bfloat16:  # both sides see the same rounded inputs
        q, k, v, do = (torch.from_numpy(x).to(dtype).float().numpy() for x in (q, k, v, do))
    jout, jlse, jgrads = _jax_run(q, k, v, do, mask, causal, tier, jdtype, dlse)
    tout, tlse, tgrads = _torch_run(q, k, v, do, mask, causal, tier, dtype, dlse)
    assert tout.shape == jout.shape and tlse.shape == jlse.shape
    _assert_close(tout, jout, dtype, "out")
    np.testing.assert_allclose(tlse, jlse, atol=2e-5, rtol=1e-6, err_msg="lse")
    for name, g, w in zip(("dq", "dk", "dv"), tgrads, jgrads):
        _assert_close(g, w, dtype, name)


@pytest.mark.parametrize("tier", ["fused", "stream"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_matches_jax_f32(tier, causal, with_mask):
    """B 2, T 100, H 3, Dh 20: T and Dh both unaligned."""
    q, k, v, do, mask = _inputs(2, 100, 3, 20, seed=7)
    _compare(q, k, v, do, mask if with_mask else None, causal, tier, torch.float32)
    assert all(n == 0 for n in tfa.launches.values())  # the CPU path launches nothing


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("tier", ["fused", "stream"])
def test_plain_matches_jax_f32_head_dims(d, tier):
    q, k, v, do, mask = _inputs(2, 100, 2, d, seed=d)
    _compare(q, k, v, do, mask, True, tier, torch.float32)


@pytest.mark.parametrize("tier", ["fused", "stream"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_bf16(tier, causal):
    q, k, v, do, mask = _inputs(2, 100, 2, 64, seed=11)
    _compare(q, k, v, do, mask, causal, tier, torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_folds_into_delta(causal):
    """``fused_attention_lse`` with a cotangent on lse too (ring attention's
    merge needs it): the gradients agree with JAX's ``_attend_lse``."""
    q, k, v, do, mask = _inputs(1, 100, 2, 32, seed=5)
    dlse = np.random.default_rng(6).normal(size=(1, 2, 100)).astype(np.float32)
    _compare(q, k, v, do, mask, causal, "fused", torch.float32, dlse=dlse)


def test_stream_walk_over_several_blocks(monkeypatch):
    """The JAX stream tier with its block pinned to 128 walks T = 384 in
    3 x 3 blocks (the online recurrence across blocks); the port computes
    the same function at once."""
    monkeypatch.setattr(jfa, "_STREAM_BLK", 128)
    q, k, v, do, mask = _inputs(1, 384, 2, 16, seed=11, mask_p=0.3)
    for causal in (False, True):
        _compare(q, k, v, do, mask, causal, "stream", torch.float32)


def test_fully_masked_rows_are_zero_and_finite():
    """Sample 0 masks every key; sample 1 masks key 0, so under causal its
    row 0 sees nothing.  Such rows output 0 with lse -1e30, and every
    gradient is finite."""
    q, k, v, do, _ = _inputs(2, 100, 2, 20, seed=3)
    mask = np.ones((2, 100), bool)
    mask[0] = False
    mask[1, 0] = False
    _compare(q, k, v, do, mask, True, "fused", torch.float32)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = tfa.fused_attention_lse(*leaves, kv_mask=torch.from_numpy(mask), causal=True)
    out.backward(torch.from_numpy(do))
    assert torch.equal(out[0], torch.zeros_like(out[0])) and torch.equal(out[1, 0], torch.zeros_like(out[1, 0]))
    lse = lse.detach()
    assert float(lse[0].max()) == float(lse[1, :, 0].max()) == np.float32(-1e30)
    assert all(bool(torch.isfinite(x.grad).all()) for x in leaves)
    assert float(leaves[0].grad[0].abs().max()) == 0.0


@pytest.mark.parametrize("plant", [None, "skips key tile 0", "does not round p, ds"])
def test_kernel_check_rejects_planted_faults(plant):
    """``chip_smoke.attention_mismatch`` (how the card's kernels are held
    to their plain versions) passes bf16 outputs summed in another order
    (every token permuted, non-causal) and rejects both planted faults in
    each of out, dq, dk and dv.  B 1, H 2, T 1024, Dh 64."""
    import chip_smoke

    q, k, v, do, _ = (torch.from_numpy(x).bfloat16() for x in _inputs(1, 1024, 2, 64, seed=4))
    mask = (torch.arange(1024) < 800).float()[None]
    out, lse = tfa.attention_fwd_plain(q, k, v, mask)
    delta = tfa.attention_delta(do, out)
    ref = (out, *tfa.attention_bwd_plain(q, k, v, mask, do, lse, delta))
    if plant is None:
        perm = torch.from_numpy(np.random.default_rng(0).permutation(1024))
        inv = torch.argsort(perm)
        qp, kp, vp, dop = (x[:, perm] for x in (q, k, v, do))
        outp, lsep = tfa.attention_fwd_plain(qp, kp, vp, mask[:, perm])
        got = (outp, *tfa.attention_bwd_plain(qp, kp, vp, mask[:, perm], dop, lsep, delta[..., perm]))
        got = tuple(x[:, inv] for x in got)
    elif plant == "skips key tile 0":
        skip = mask.clone()
        skip[:, :64] = 0.0
        got = (tfa.attention_fwd_plain(q, k, v, skip)[0], *tfa.attention_bwd_plain(q, k, v, skip, do, lse, delta))
    else:
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        got = (tfa.attention_fwd_plain(qf, kf, vf, mask)[0], *tfa.attention_bwd_plain(qf, kf, vf, mask, dof, lse, delta))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, ref):
        rel_max, rel_rms, ok = chip_smoke.attention_mismatch(g.to(w.dtype), w, "bfloat16")
        assert ok == (plant is None), (name, rel_max, rel_rms)


def test_plain_chunks_over_heads(monkeypatch):
    """The plain version's memory bound (chunks of heads) changes nothing."""
    q, k, v, do, mask = _inputs(2, 64, 4, 16, seed=9)
    args = [torch.from_numpy(x) for x in (q, k, v)] + [torch.from_numpy(mask).float()]
    whole = tfa.attention_fwd_plain(*args, causal=True)
    monkeypatch.setattr(tfa, "_PLAIN_CHUNK_ELEMS", 64 * 64)  # one head at a time
    chunked = tfa.attention_fwd_plain(*args, causal=True)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- routing
T_GRID = [1, 64, 100, 128, 1000, 1023, 1024, 1025, 2048, 4096, 8000, 8192, 8193, 16384, 32768, 32769]
D_GRID = [16, 20, 32, 64, 65, 100, 128, 129]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("perf_gate", [True, False])
def test_kernel_tier_agrees_with_jax_on_tpu(monkeypatch, itemsize, perf_gate):
    """The port routes as the JAX package does on the TPU, ``MIN_FUSED_T``
    floor included."""
    monkeypatch.setattr(jfa, "_mode", lambda: "tpu")
    for t in T_GRID:
        for d in D_GRID:
            want = jfa.kernel_tier(t, d, itemsize, _perf_gate=perf_gate)
            assert tfa.kernel_tier(t, d, itemsize, _perf_gate=perf_gate) == want, (t, d)
            if perf_gate:
                assert tfa.kernel_eligible(t, d, itemsize) == jfa.kernel_eligible(t, d, itemsize)


def test_main_shapes_take_the_expected_tiers():
    assert tfa.kernel_tier(8192, 64, 2) == "fused"  # bf16 main path: K6-K8
    assert tfa.kernel_tier(8192, 64, 4) == "stream"  # f32: K9-K11
    assert tfa.kernel_tier(16384, 64, 2) == "stream"
    assert tfa.kernel_tier(512, 64, 2) is None  # below MIN_FUSED_T: dense


@pytest.mark.parametrize(
    "shape,mask_shape,rate,deterministic,kv_len",
    [
        ((2, 2048, 4, 64), (2, 1, 1, 2048), 0.0, True, None),
        ((2, 2048, 4, 64), None, 0.1, False, None),  # probability dropout
        ((2, 2048, 4, 64), (2, 1, 2048, 2048), 0.0, True, None),  # query-dependent mask
        ((2, 2048, 4, 64), None, 0.0, True, 1024),  # cross-attention
        ((2, 512, 4, 64), None, 0.0, True, None),  # below the floor
        ((2, 2048, 4, 256), None, 0.0, True, None),  # head dim past 128
    ],
)
def test_eligible_agrees_with_jax_on_tpu(monkeypatch, shape, mask_shape, rate, deterministic, kv_len):
    monkeypatch.setattr(jfa, "_mode", lambda: "tpu")
    q_t = torch.zeros(shape, dtype=torch.bfloat16)
    q_j = jnp.zeros(shape, jnp.bfloat16)
    m_t = None if mask_shape is None else torch.ones(mask_shape, dtype=torch.bool)
    m_j = None if mask_shape is None else jnp.ones(mask_shape, bool)
    k_t = k_j = None
    if kv_len:
        k_t = torch.zeros(shape[0], kv_len, *shape[2:])
        k_j = jnp.zeros((shape[0], kv_len, *shape[2:]))
    assert tfa.eligible(q_t, m_t, rate, deterministic, k=k_t) == jfa.eligible(
        q_j, m_j, rate, deterministic, k=k_j
    )


# ---------------------------------------------------------------- wrappers
@pytest.mark.parametrize(
    "dtype,shape,exc",
    [
        (torch.float16, (1, 64, 2, 32), TypeError),
        (torch.float32, (1, 64, 2, 130), ValueError),  # Dh > 128
        (torch.float32, (1, 64, 32), ValueError),  # not [B, T, H, Dh]
    ],
)
def test_wrappers_reject(dtype, shape, exc):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(exc):
        tfa.attention_fwd(x, x, x)


def test_wrappers_reject_bad_tier_and_mask():
    x = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError, match="tier"):
        tfa.attention_fwd(x, x, x, tier="dense")
    with pytest.raises(ValueError, match="kv_mask"):
        tfa.attention_fwd(x, x, x, kv_mask=torch.ones(1, 64, dtype=torch.bool))
    with pytest.raises(ValueError, match="no kernel tier"):
        tfa.fused_attention(torch.zeros(1, 64, 2, 256), torch.zeros(1, 64, 2, 256), torch.zeros(1, 64, 2, 256))


def test_strided_views_of_a_packed_projection():
    """q/k/v as views of one ``[B, T, 3, H, Dh]`` tensor (the model's
    layout) give what contiguous copies give."""
    rng = np.random.default_rng(2)
    packed = torch.from_numpy(rng.normal(size=(2, 80, 3, 2, 24)).astype(np.float32))
    views = packed.unbind(dim=2)
    copies = [x.contiguous() for x in views]
    a = tfa.fused_attention(*views, causal=True, tier="fused")
    b = tfa.fused_attention(*copies, causal=True, tier="fused")
    assert torch.equal(a, b)


# ------------------------------------------------------------------ routes
def _packed(b, t, h, d, dtype, extra=0, offset=0):
    """q, k, v as views of one packed ``[B, T, 3, H, Dh]`` projection (the
    models' layout); ``extra`` elements pad each token's row and ``offset``
    shifts every base, to break the TMA route's alignment."""
    flat = torch.zeros(b, t, 3 * h * d + extra + offset, dtype=dtype)
    packed = flat[..., offset:offset + 3 * h * d].view(b, t, 3, h, d)
    return packed.unbind(dim=2)


@pytest.mark.parametrize(
    "make,route",
    [
        # the long-context main path (LC_MAIN) and the causal LM: packed bf16 at Dh 64
        (lambda: _packed(2, 256, 8, 64, torch.bfloat16), "wgmma"),
        (lambda: _packed(1, 1000, 4, 64, torch.bfloat16), "wgmma"),
        (lambda: _packed(2, 128, 4, 32, torch.bfloat16), "wgmma"),  # Dh 32: the 64-byte swizzle
        (lambda: [torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)] * 3, "wgmma"),  # contiguous, H 1
        (lambda: _packed(2, 100, 4, 20, torch.bfloat16), "mma"),  # ragged Dh
        (lambda: _packed(2, 128, 4, 48, torch.bfloat16), "mma"),  # Dh 48: no wgmma instance
        (lambda: _packed(2, 128, 4, 64, torch.bfloat16, extra=1), "mma"),  # token stride not 16 bytes
        (lambda: _packed(2, 128, 4, 64, torch.bfloat16, offset=1), "mma"),  # base not 16-byte aligned
        # heads outside tokens ([B, H, T, Dh] viewed as [B, T, H, Dh]): not nested
        (lambda: [torch.zeros(2, 4, 128, 64, dtype=torch.bfloat16).transpose(1, 2)] * 3, "mma"),
        # f32 at Dh 64 on the packed layout: the 3xTF32 kernels
        (lambda: _packed(2, 128, 4, 64, torch.float32), "tf32x3"),
        (lambda: _packed(2, 128, 4, 128, torch.bfloat16), "fma"),  # Dh 128 in bf16
        (lambda: _packed(2, 128, 4, 20, torch.float32), "fma"),
        (lambda: _packed(2, 128, 4, 32, torch.float32), "tf32x3"),  # f32 at Dh 32
        (lambda: _packed(2, 128, 4, 64, torch.float32, offset=1), "fma"),  # base 4 bytes off 16
        (lambda: _packed(2, 128, 4, 128, torch.float32), "fma"),  # Dh 128 in f32
    ],
)
def test_kernel_route_follows_the_layout_rule(make, route, monkeypatch):
    q, k, v = make()
    dout = torch.zeros(q.shape, dtype=q.dtype)
    assert tfa.kernel_route(q, k, v) == route
    assert tfa.kernel_route(q, k, v, dout) == route
    # the forward, dq and dk/dv each have a kernel on every route (no
    # stand-in family for any kind), and each route's launches are counted
    assert not hasattr(tfa, "family") and not hasattr(tfa, "STAND_IN")
    assert all(f"{kind}/{route}" in tfa.route_launches for kind in ("fwd", "dq", "dkv"))
    # dq follows the same rule as dk/dv (no dq-specific family): its wrapper
    # asks kernel_route, with dout
    asked = []
    monkeypatch.setattr(tfa, "kernel_route", lambda *xs: asked.append(xs) or "fma")
    stat = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    tfa.attention_dq(q, k, v, None, dout, stat, stat)
    assert len(asked) == 1 and all(a is b for a, b in zip(asked[0], (q, k, v, dout)))
    assert not hasattr(tfa, "dq_route")


def test_kernel_route_needs_a_describable_dout():
    q, k, v = _packed(2, 128, 4, 64, torch.bfloat16)
    dout = torch.zeros(2, 128, 4, 65, dtype=torch.bfloat16)[..., 1:]  # base off by 2 bytes
    assert tfa.kernel_route(q, k, v) == "wgmma"
    assert tfa.kernel_route(q, k, v, dout) == "mma"


@pytest.mark.parametrize("call", ["fwd", "dq", "dkv"])
def test_wrappers_refuse_an_unknown_route(call):
    x = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16)
    stat = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="route"):
        if call == "fwd":
            tfa.attention_fwd(x, x, x, route="tensor_core")
        elif call == "dq":
            tfa.attention_dq(x, x, x, None, x, stat, stat, route="wgmma2")
        else:
            tfa.attention_dkv(x, x, x, None, x, stat, stat, route="")


def test_a_named_route_computes_the_same_function_on_the_cpu():
    """On CPU tensors every route is the plain version: naming one changes
    the kernel family on the card, never the function."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 96, 2, 32)).astype(np.float32)).to(torch.bfloat16)
    want = tfa.attention_fwd(x, x, x, causal=True)
    for route in tfa.ROUTES:
        got = tfa.attention_fwd(x, x, x, causal=True, route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_tf32x3_route_computes_the_plain_version_on_the_cpu():
    """A named ``"tf32x3"`` route gives the forward's, dq's and dk/dv's
    plain versions on CPU tensors, and each kind's launches on that route
    are counted (``"dq/tf32x3"`` among them)."""
    rng = np.random.default_rng(8)
    q, k, v = (x.copy_(torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)))
               for x in _packed(1, 96, 2, 64, torch.float32))
    mask = torch.from_numpy((rng.random((1, 96)) > 0.3).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    assert tfa.kernel_route(q, k, v, dout) == "tf32x3"
    out, lse = tfa.attention_fwd(q, k, v, mask, causal=True, route="tf32x3")
    want_out, want_lse = tfa.attention_fwd_plain(q, k, v, mask, causal=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    delta = tfa.attention_delta(dout, out)
    want = tfa.attention_bwd_plain(q, k, v, mask, dout, lse, delta, causal=True)
    dk, dv = tfa.attention_dkv(q, k, v, mask, dout, lse, delta, causal=True, route="tf32x3")
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    dq = tfa.attention_dq(q, k, v, mask, dout, lse, delta, causal=True, route="tf32x3")
    assert torch.equal(dq, want[0])
    assert torch.equal(tfa.attention_dq(q, k, v, mask, dout, lse, delta, causal=True), want[0])
    assert {"fwd/tf32x3", "dq/tf32x3", "dkv/tf32x3"} <= set(tfa.route_launches)
    assert all(n == 0 for n in tfa.route_launches.values())  # the CPU path launches nothing


@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_products_keep_the_f32_check(monkeypatch, causal):
    """The 3xTF32 kernels' arithmetic (``chip_smoke.tf32_products_attention``:
    each f32 operand split into a TF32 big part, its low 13 mantissa bits
    dropped, and the rest; three TF32 products for each f32 product)
    agrees with the JAX stream tier (K9 ``_fwd_stream``, K10 and K11
    ``_bwd_stream`` in interpret mode, T 384 walked in 3 x 3 blocks of
    128) within ``chip_smoke.ATTN_TOL["float32"]`` on out, dq, dk and dv;
    with TF32 products alone (1xTF32) it fails that tolerance on each."""
    import chip_smoke

    monkeypatch.setattr(jfa, "_STREAM_BLK", 128)
    q, k, v, do, mask = _inputs(1, 384, 2, 64, seed=13, mask_p=0.3)
    jout, jlse, jgrads = _jax_run(q, k, v, do, mask, causal, "stream", jnp.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = torch.from_numpy(np.array(jlse))
    want = [torch.from_numpy(np.array(x)) for x in (jout, *jgrads)]
    delta = tfa.attention_delta(tdo, want[0])
    for passes in (3, 1):
        got = chip_smoke.tf32_products_attention(
            tq, tk, tv, torch.from_numpy(mask).float(), tdo, lse, delta, causal, passes
        )
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            rel_max, rel_rms, ok = chip_smoke.attention_mismatch(g, w, "float32")
            assert ok == (passes == 3), (passes, name, rel_max, rel_rms)


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header gives every library a new file name,
    so a build made before the edit is never loaded."""
    from distributed_learning_simulator_tpu_torch.ops import build

    (tmp_path / "kernel.cu").write_text('#include "helpers.cuh"\n')
    header = tmp_path / "helpers.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = build.library_path("kernel")
    header.write_text("// v2\n")
    assert build.library_path("kernel") != before
    assert build.headers() == [str(header)]


def test_build_keeps_the_compiler_report_beside_the_library(tmp_path, monkeypatch):
    """A build writes its ``ptxas`` output beside the library, compiles a
    library once, and compiles it again when the report is missing."""
    import os

    from distributed_learning_simulator_tpu_torch.ops import build

    csrc, calls, nvcc = tmp_path / "csrc", tmp_path / "calls", tmp_path / "nvcc"
    csrc.mkdir()
    (csrc / "kernel.cu").write_text("// kernel\n")
    nvcc.write_text(
        f"#!/bin/sh\necho call >> {calls}\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; shift; done\n'
        ': > "$out"\necho "ptxas info    : Used 10 registers"\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    build.build(["kernel"])
    assert os.path.isfile(build.library_path("kernel"))
    assert "Used 10 registers" in build.report("kernel")
    build.build(["kernel"])
    assert calls.read_text().split() == ["call"]
    os.remove(build.report_path("kernel"))
    build.build(["kernel"])
    assert calls.read_text().split() == ["call", "call"]
    assert "Used 10 registers" in build.report("kernel")


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_bound_counts_only_the_valid_pairs(causal):
    """``chip_smoke.py``'s K6-K11 bound counts the (query, key) pairs that
    the mask and the causal flag leave valid (the plain version's own
    validity: every other pair gives p = 0 exactly), and reads the k and v
    rows of valid keys only."""
    import chip_smoke

    b, h, t, dh = 3, 2, 96, 32
    rng = np.random.default_rng(11)
    mask = torch.from_numpy((rng.random((b, t)) > 0.4).astype(np.float32))
    mask[2] = 0.0
    flops, nbytes = chip_smoke._fused_work((b, h, t, dh, "bfloat16", causal, "pad"), mask)
    pairs = h * sum(int(tfa._valid(mask, bi, t, causal, "cpu").sum()) for bi in range(b))
    for part, products in (("fwd", 2), ("dq", 3), ("dkv", 4)):
        assert flops[part] == products * 2 * pairs * dh
    act, kv = b * t * h * dh * 2, int(mask.sum()) * h * dh * 2
    assert nbytes["fwd"] == 2 * act + 2 * kv + b * t * 4 + b * h * t * 4
    # f32: the same pairs; the bound is 3 TF32 products a product on the
    # tensor cores (495 TFLOP/s), the FMA units' bound (67 TFLOP/s) beside it
    f32_flops, f32_bytes = chip_smoke._fused_work((b, h, t, dh, "float32", causal, "pad"), mask)
    assert f32_flops == flops
    for part in ("fwd", "dq", "dkv"):
        row = chip_smoke.attention_bound_ms(f32_bytes[part], f32_flops[part], "float32")
        t_bytes, t_ops = f32_bytes[part] / 3.35e12 * 1e3, 3 * f32_flops[part] / 495e12 * 1e3
        assert row["bound_ms"] == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
        assert row["bound_by"] == ("operations" if t_ops >= t_bytes else "bytes")
        assert row["fma_bound_ms"] == pytest.approx(max(t_bytes, f32_flops[part] / 67e12 * 1e3), rel=1e-12)
    assert "fma_bound_ms" not in chip_smoke.attention_bound_ms(nbytes["fwd"], flops["fwd"], "bfloat16")
