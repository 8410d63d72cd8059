"""The QSGD codec of the port against the JAX package's.

K2/K3 (``ops/qsgd.py``): the plain versions against the JAX Pallas kernels
run in interpret mode on the CPU, which draw ``jax.random.bits(PRNGKey(
seed), (rows, 128))``; the port's plain encode is handed the same bits,
so packed words, sign words and scale must be bit-equal, and so must the
decode of the JAX payload.  The codec (``ops/quantization.py``): with a
random source that returns the JAX package's draws, every branch's blob
is bit-equal to the JAX codec's with ``use_pallas=True``.  Also the
kernels' statistical properties, the launch counters under threads and
the compression ratio.
"""

import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.ops import pallas_kernels as pk
from distributed_learning_simulator_tpu.ops import quantization as jq
from distributed_learning_simulator_tpu_torch.ops import qsgd
from distributed_learning_simulator_tpu_torch.ops import quantization as tq
from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa


class JaxCodecRandom(tq.CodecRandom):
    """The JAX package's draws for each of the codec's requests (keys are
    JAX PRNG keys); counts the K2 route's requests."""

    def __init__(self) -> None:
        self.kernel_calls = 0

    @staticmethod
    def _uniform(key, shape):
        return torch.from_numpy(np.asarray(jax.random.uniform(key, tuple(shape))))

    def leaf_uniform(self, seed, index, count, shape, device):
        return self._uniform(jax.random.split(jax.random.PRNGKey(seed), count)[index], shape)

    def keyed_uniform(self, key, index, count, shape, device, fold_index=None):
        if fold_index is not None:
            return self._uniform(jax.random.fold_in(key, fold_index), shape)
        return self._uniform(jax.random.split(key, count)[index], shape)

    def flat_uniform(self, seed, shape, device):
        return self._uniform(jax.random.PRNGKey(seed), shape)

    def kernel_bits(self, seed, rows, device):
        self.kernel_calls += 1
        bits = jax.random.bits(jax.random.PRNGKey(seed), (rows, qsgd.LANE), jnp.uint32)
        return torch.from_numpy(np.asarray(bits).astype(np.int64))


def _words(a) -> np.ndarray:
    """u32 words of a JAX array or an int64/int32 tensor, as int64."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.int64).numpy() & 0xFFFFFFFF
    return np.asarray(a).astype(np.int64)


def _leaf(n: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(n).astype(np.float32)


# ---------------------------------------------------------------- K2 / K3
#: the widths of the task (8, 4 and 2 bits), four whose level words do not
#: fill 32 bits (3 bits: 10 lanes, 160-row groups; 5 bits: 6 lanes, 96 rows;
#: 6 bits: 5 lanes, 160 rows; 10 bits: 3 lanes, 96 rows: K3's generic
#: instantiation) and two with fewer than 4 lanes (16 bits: 2; 24 bits: 1,
#: the widest level f32 holds exactly)
BITS_LEVELS = [(8, 255), (4, 15), (2, 3), (3, 7), (5, 31), (6, 63), (10, 1023), (16, 65535), (24, 16777215)]


@pytest.mark.parametrize("n", [100, 1024, 5000, 65536, 70001, "zeros"])
@pytest.mark.parametrize("bits,level", BITS_LEVELS)
def test_plain_kernels_are_bit_equal_to_jax(n, bits, level):
    x = np.zeros(4096, np.float32) if n == "zeros" else _leaf(n, seed=bits)
    seed = 11
    jpacked, jsigns, jscale = pk.qsgd_encode(jnp.asarray(x), seed=seed, level=level, bits=bits)
    rows = qsgd.rows_for(x.size, bits)
    rand = JaxCodecRandom().kernel_bits(seed, rows, "cpu")
    packed, signs, scale = qsgd.qsgd_encode_plain(torch.from_numpy(x), level, bits, rand)
    np.testing.assert_array_equal(_words(packed), _words(jpacked))
    np.testing.assert_array_equal(_words(signs), _words(jsigns))
    assert scale.numpy().tobytes() == np.asarray(jscale, np.float32).tobytes()
    jout = np.asarray(pk.qsgd_decode(jpacked, jsigns, jscale, level=level, bits=bits, n=x.size))
    tout = qsgd.qsgd_decode_plain(
        torch.from_numpy(_words(jpacked)), torch.from_numpy(_words(jsigns)),
        torch.from_numpy(np.asarray(jscale)), level, bits, x.size,
    )
    assert tout.numpy().tobytes() == jout.tobytes()


@pytest.mark.parametrize("n", [100, 1024, 5000])
@pytest.mark.parametrize("bits,level", BITS_LEVELS)
def test_roundtrip_error_below_one_step(n, bits, level):
    """The JAX package's kernel properties on the port's CPU route (bits
    from a seeded torch.Generator): error under one step, signs kept above
    one step."""
    x = torch.from_numpy(_leaf(n))
    packed, signs, scale = qsgd.qsgd_encode(x, seed=7, level=level, bits=bits)
    decoded = qsgd.qsgd_decode(packed, signs, scale, level, bits, n)
    step = float(scale[0]) / level
    assert float((decoded - x).abs().max()) < step + 1e-6
    big = x.abs() > step
    assert torch.equal(torch.sign(decoded)[big], torch.sign(x)[big])


def test_decode_is_unbiased_over_seeds():
    x = torch.tensor([0.3, -0.7, 0.123, 0.999])
    acc = torch.zeros(4, dtype=torch.float64)
    trials = 200
    for seed in range(trials):
        packed, signs, scale = qsgd.qsgd_encode(x, seed=seed, level=15, bits=4)
        acc += qsgd.qsgd_decode(packed, signs, scale, 15, 4, 4).double()
    np.testing.assert_allclose((acc / trials).numpy(), x.double().numpy(), atol=0.02)


def test_compressed_size_under_a_third():
    n = 10000
    packed, signs, scale = qsgd.qsgd_encode(torch.from_numpy(_leaf(n, 1)), seed=0, level=255, bits=8)
    compressed = 4 * (packed.numel() + signs.numel() + scale.numel())  # u32 words, f32 scale
    assert compressed < 0.35 * 4 * n  # 8 + 1 bits against 32


def test_cpu_route_draws_from_a_seeded_generator():
    x = torch.from_numpy(_leaf(3000))
    rows = qsgd.rows_for(3000, 8)
    a = qsgd.qsgd_encode(x, seed=5, level=255, bits=8)
    b = qsgd.qsgd_encode_plain(x, 255, 8, qsgd.generator_bits(5, rows, "cpu"))
    c = qsgd.qsgd_encode(x, seed=6, level=255, bits=8)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])


# ------------------------------------------------------ the card's Philox stream
def test_philox_matches_the_published_vector():
    """``qsgd.philox4x32`` is Philox4x32-10: counter 0 under key 0 gives the
    reference implementation's known answer (Random123's ``kat_vectors``)."""
    words = qsgd.philox4x32([0], 0)[0]
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_four_neighbouring_rows_share_one_philox_call(seed):
    """Rows ``4g .. 4g + 3`` of column ``c`` take the four words of the call
    whose counter is ``g * 128 + c``: at 8 bits a level word's four values
    come from one call."""
    rows = 40
    stream = qsgd.philox_stream(seed, rows).numpy()
    for g, c in [(0, 0), (0, 127), (3, 5), (9, 64)]:
        words = qsgd.philox4x32([g * qsgd.LANE + c], seed)[0].astype(np.int64)
        np.testing.assert_array_equal(stream[4 * g:4 * g + 4, c], words)
    assert len(np.unique(stream)) > 0.99 * stream.size  # 32-bit draws: few repeats


def test_philox_stream_depends_only_on_seed_and_index():
    """The bits of element ``(row, column)`` do not depend on how many rows
    the leaf has (a ragged row count included), and another seed gives
    other bits."""
    short, long = qsgd.philox_stream(3, 34), qsgd.philox_stream(3, 160)
    assert short.shape == (34, qsgd.LANE) and short.dtype == torch.int64
    assert torch.equal(short, long[:34])
    assert int(long.min()) >= 0 and int(long.max()) < 1 << 32
    assert (qsgd.philox_stream(4, 34) != short).float().mean() > 0.99


@pytest.mark.parametrize("bits,level", [(3, 7), (5, 31), (7, 127), (8, 255)])
def test_encode_with_the_philox_stream_is_bit_equal_to_jax(monkeypatch, bits, level):
    """The card's stream (``qsgd.philox_stream``) fed to the port's plain
    encode and to the JAX ``qsgd_encode`` (its interpreter path, with
    ``jax.random.bits`` answering that stream) gives the same packed words,
    signs and scale, at widths whose level words do and do not fill 32
    bits."""
    x = _leaf(70001, seed=bits)
    seed, rows = 21, qsgd.rows_for(x.size, bits)
    stream = qsgd.philox_stream(seed, rows)

    def bits_of(key, shape, dtype):
        assert tuple(shape) == (rows, qsgd.LANE)
        return jnp.asarray(stream.numpy().astype(np.uint32))

    monkeypatch.setattr(jax.random, "bits", bits_of)
    jpacked, jsigns, jscale = pk.qsgd_encode.__wrapped__(jnp.asarray(x), seed=seed, level=level, bits=bits)
    packed, signs, scale = qsgd.qsgd_encode_plain(torch.from_numpy(x), level, bits, stream)
    np.testing.assert_array_equal(_words(packed), _words(jpacked))
    np.testing.assert_array_equal(_words(signs), _words(jsigns))
    assert scale.numpy().tobytes() == np.asarray(jscale, np.float32).tobytes()


def test_encode_bound_counts_philox_at_one_call_per_four_values():
    """``chip_smoke.py``'s K2 bound: the larger of the bytes, the f32
    operations and Philox's integer operations (100 a call, one call per
    four values, at 64 INT32 lanes an SM)."""
    import chip_smoke

    n, words = 2359296, 2359296 // 4 + 2359296 // 32
    row = chip_smoke.encode_bound_ms(n, words)
    terms = row["bound_terms_ms"]
    assert terms["bytes"] == pytest.approx((4 * n + 4 * words + 4) / 3.35e12 * 1e3, rel=1e-12)
    assert terms["f32"] == pytest.approx(6 * n / 67e12 * 1e3, rel=1e-12)
    assert terms["int32"] == pytest.approx(100 * n / 4 / (64 * 132 * 1.98e9) * 1e3, rel=1e-12)
    assert row["bound_ms"] == max(terms.values())
    assert row["bound_by"] == ("bytes" if terms["bytes"] >= terms["int32"] else "operations")


def test_decode_bound_counts_each_word_once():
    """``chip_smoke.py``'s K3 bound: the larger of the bytes (each level and
    sign word and the scale read once, each value written once) and the
    f32 operations (3 a value); at the main leaf the bytes, 3.609 µs."""
    import chip_smoke

    n, words = 2359296, 2359296 // 4 + 2359296 // 32
    row = chip_smoke.decode_bound_ms(n, words)
    terms = row["bound_terms_ms"]
    assert terms["bytes"] == pytest.approx((4 * words + 4 + 4 * n) / 3.35e12 * 1e3, rel=1e-12)
    assert terms["f32"] == pytest.approx(3 * n / 67e12 * 1e3, rel=1e-12)
    assert (row["bound_ms"], row["bound_by"]) == (terms["bytes"], "bytes")
    assert row["bound_ms"] == pytest.approx(3.609e-3, rel=1e-3)
    small = chip_smoke.decode_bound_ms(589824, 589824 // 4 + 589824 // 32)
    assert small["bound_ms"] == pytest.approx(0.9023e-3, rel=1e-3)


def test_chip_smoke_holds_every_decode_instantiation():
    """``chip_smoke.py``'s K2/K3 cases reach each instantiation of K3's
    kernel (lanes 32, 16, 8, 4, 2 and 1, and the generic one of lanes 10,
    6, 5 and 3), each at a ragged and at a whole leaf size somewhere."""
    import chip_smoke

    lanes = {32 // bits for _, bits, _, _ in chip_smoke.QSGD_CASES}
    assert lanes == {32, 16, 10, 8, 6, 5, 4, 3, 2, 1}
    assert {n % 128 != 0 for n, _, _, _ in chip_smoke.QSGD_CASES} == {True, False}
    assert chip_smoke.QSGD_MAIN in chip_smoke.QSGD_CASES and chip_smoke.QSGD_SMALL_LEAF in chip_smoke.QSGD_CASES
    for n, bits, level, _ in chip_smoke.QSGD_CASES:
        assert level == (1 << bits) - 1 and 1 <= bits <= qsgd.KERNEL_MAX_BITS


# ---------------------------------------------------------------- the codec
def _jax_tree() -> dict[str, np.ndarray]:
    """A tree in the JAX package's keys: two leaves on the K2 route (one
    ragged), small 1-d and 2-d leaves on the consecutive packer."""
    rng = np.random.RandomState(3)
    return {
        "Dense_0/kernel": rng.randn(256, 300).astype(np.float32),  # 76,800
        "Dense_0/bias": rng.randn(300).astype(np.float32),
        "Embed_0/embedding": rng.randn(65536).astype(np.float32).reshape(512, 128),
        "LayerNorm_0/scale": rng.randn(40).astype(np.float32),
        "head/kernel": rng.randn(64, 10).astype(np.float32) * 1e-3,
    }


def _assert_blobs_equal(tblob: dict, jblob: dict) -> None:
    assert len(tblob["leaves"]) == len(jblob["leaves"])
    for tenc, jenc in zip(tblob["leaves"], jblob["leaves"]):
        assert tenc["pallas"] == jenc["pallas"]
        assert tuple(tenc["shape"]) == tuple(jenc["shape"])
        np.testing.assert_array_equal(_words(tenc["packed"]), _words(jenc["packed"]))
        np.testing.assert_array_equal(_words(tenc["signs"]), _words(jenc["signs"]))
        key = "scales" if "scales" in jenc else "scale"
        assert tenc[key].numpy().tobytes() == np.asarray(jenc[key], np.float32).tobytes()


@pytest.mark.parametrize("branch", ["per_leaf", "flat", "keyed_split", "keyed_fold"])
def test_codec_blobs_are_bit_equal_to_jax(branch):
    """Fed the JAX draws, every branch of the port's codec encodes the JAX
    codec's blob (``use_pallas=True``: leaves of 65,536 values and more
    through K2) and decodes it to the same values, with the same routing
    and compression ratio."""
    tree = _jax_tree()
    jquant, jdequant = jq.stochastic_quantization(255, use_pallas=True)
    tquant, tdequant = tq.stochastic_quantization(255, random=JaxCodecRandom())
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    key = jax.random.PRNGKey(9)
    fold = {name: 3 * i + 1 for i, name in enumerate(sorted(tree))}
    kwargs = {
        "per_leaf": ({"seed": 4}, {"seed": 4}),
        "flat": ({"seed": 4, "flat": True}, {"seed": 4, "flat": True}),
        "keyed_split": ({"key": key}, {"key": key}),
        "keyed_fold": ({"key": key, "fold_indices": fold}, {"key": key, "fold_indices": fold}),
    }[branch]
    jblob = jquant(jtree, **kwargs[0])
    tblob = tquant(ttree, **kwargs[1])
    _assert_blobs_equal(tblob, jblob)
    flags = [enc["pallas"] for enc in tblob["leaves"]]
    assert flags == ([False, True, True, False, False] if branch == "per_leaf" else [False] * len(flags))
    assert tq.check_compression_ratio(ttree, tblob) == pytest.approx(
        jq.check_compression_ratio(jtree, jblob), rel=1e-12
    )
    jout, tout = jdequant(jblob), tdequant(tblob)
    assert sorted(tout) == sorted(jout)
    for name in jout:
        assert tout[name].numpy().tobytes() == np.asarray(jout[name]).tobytes(), name


def test_flat_payload_round_trips_within_one_step_per_tensor():
    tree = {k: torch.from_numpy(v) for k, v in _jax_tree().items()}
    quant, dequant = tq.stochastic_quantization(255)
    blob = quant(tree, seed=1, flat=True)
    assert "flat_layout" in blob and len(blob["leaves"]) == 1
    out = dequant(blob)
    for name, value in tree.items():
        step = float(value.abs().max()) / 255
        assert float((out[name] - value).abs().max()) < step + 1e-7, name


# ---------------------------------------------------------------- counters
def test_launch_counters_are_exact_under_threads(monkeypatch):
    """8 threads call K1's wrapper on its CUDA path (the card's library and
    tensors faked) and the count comes out exact; a short switch interval
    makes the threads interleave inside the wrapper."""

    class FakeCudaTensor:
        device = types.SimpleNamespace(type="cuda")
        dtype = torch.float32

        def __init__(self, *shape):
            self.shape = shape

        def dim(self):
            return len(self.shape)

        def stride(self, i):
            return 1

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 0

        # the wrapper plans from the storage the rows lie in
        def element_size(self):
            return 4

        def storage_offset(self):
            return 0

        def untyped_storage(self):
            return types.SimpleNamespace(nbytes=lambda: 4 * int(np.prod(self.shape)))

    fake_torch = types.SimpleNamespace(
        float32=torch.float32,
        bfloat16=torch.bfloat16,
        empty=lambda *a, **k: FakeCudaTensor(*a),
        cuda=types.SimpleNamespace(
            current_stream=lambda device: types.SimpleNamespace(cuda_stream=0),
            device=lambda device: threading.Lock(),  # any context manager
        ),
    )
    monkeypatch.setattr(wa, "torch", fake_torch)
    monkeypatch.setattr(wa, "_library", lambda: lambda *args: 0)
    monkeypatch.setattr(wa, "launches", 0)
    monkeypatch.setattr(wa, "route_launches", {variant: 0 for variant in wa.VARIANTS})
    x, w = FakeCudaTensor(2, 8), FakeCudaTensor(2)
    calls = 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [wa.weighted_accum(x, w) for _ in range(calls)])
            for _ in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert wa.launches == 8 * calls
    assert sum(wa.route_launches.values()) == 8 * calls
