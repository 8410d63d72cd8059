"""The port's FedOBD, FedOBD-SQ and FedPAQ on the SPMD session against the
JAX package's.

* The codecs' value distortion (``ops/quantization.py``): NNADQ bit for
  bit on ``test_nnadq_golden.py``'s input, zero, constant and random
  tensors; QSGD bit for bit given the JAX uniforms, at levels 255 and 15.
  Both against the JAX functions compiled (``jax.jit``), as the JAX
  session's round program runs them: there XLA fuses NNADQ's last
  multiply-add and reassociates QSGD's ``sign(x) * q / level * scale``,
  so op-by-op evaluation differs from the session in last bits.
* fed_obd trajectories from one init: LeNet5 on MNIST in f32 and the
  IMDB classifier (``EncoderLayer`` dropout 0 in both packages inside the
  test), 4 workers, 2 rounds and 2 tuning epochs, with full participation
  and with 2 clients a round (the per-slot optimizer carry): every record's
  test loss at rtol 1e-4, accuracy, phase and wire MB equal, and the final
  npz.
* fed_obd_sq and fed_paq the same way, the port's codec fed the JAX
  session's own draws (rebuilt from its key chain by a random source made
  in the test).
* DenseNet-40's real parameter set (through the weight bridge): its block
  partition against JAX ``get_module_blocks``, and the port's phase-1
  upload of a seeded perturbation against a per-leaf reference built from
  JAX ``nnadq_quantize_dequantize`` and the JAX session's greedy
  selection.  A JAX DenseNet-40 session round takes minutes to compile on
  the CPU; ``chip_smoke.py`` holds the full DenseNet round card against CPU.

Where the codecs' rounding meets an element on a level boundary, the two
packages' last-bit differences in training can move it by one level.  The
final-npz check counts such elements (at most 0.1% of them) and holds
each to what one flip moves it: a client's upload step times its share of
the weight, or the step of the broadcast it trained from.  In these runs
one element took one, in the classifier's fed_obd with 2 selected (and
187 of 2,242,802 in ``test_torch_fed_obd_files.py``'s ``fed_obd/imdb.yaml``).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.method.fed_obd import obd_algorithm as jobd
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.ops import quantization as jq
from distributed_learning_simulator_tpu.parallel.mesh import client_slots, make_mesh
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.ops import quantization as tq
from distributed_learning_simulator_tpu_torch.parallel import spmd_obd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the K1 launch count and the codec's step record)
from test_nnadq_golden import GOLDEN_BITS, fixed_tensor  # noqa: E402

ROUNDS, TUNING = 2, 2
WORKERS = 4


# ---------------------------------------------------------------- codecs
def _nnadq_inputs():
    rng = np.random.RandomState(3)
    cases = {"golden": fixed_tensor(), "zeros": np.zeros(300, np.float32), "constant": np.full(77, 1.5, np.float32)}
    for i, (n, scale) in enumerate([(1, 1.0), (1000, 1e-4), (4097, 0.05), (20000, 3.0)]):
        cases[f"randn{i}"] = (rng.randn(n) * scale).astype(np.float32)
    return cases


#: the JAX codecs as the JAX session runs them: inside a compiled program
_jax_nnadq = jax.jit(jq.nnadq_quantize_dequantize, static_argnums=1)
_jax_qsgd = jax.jit(jq.qsgd_quantize_dequantize, static_argnums=2)


@pytest.mark.parametrize("name", sorted(_nnadq_inputs()))
def test_nnadq_matches_jax_bit_for_bit(name):
    x = _nnadq_inputs()[name]
    weights = sorted(GOLDEN_BITS) + [0.01 * 3, 0.5]
    for weight in weights:
        jout, jbits = _jax_nnadq(jnp.asarray(x), weight)
        tout, tbits = tq.nnadq_quantize_dequantize(torch.from_numpy(x), weight)
        assert float(tbits) == float(jbits), (name, weight)
        assert tout.numpy().tobytes() == np.asarray(jout).tobytes(), (name, weight)
        if name == "golden":
            assert float(tbits) == GOLDEN_BITS.get(weight, float(tbits))


@pytest.mark.parametrize("level", [255, 15])
def test_qsgd_quantize_dequantize_matches_jax_given_its_uniforms(level):
    rng = np.random.RandomState(level)
    for trial, n in enumerate([1, 100, 4097, 30000]):
        x = (rng.randn(n) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
        if trial == 1:
            x[:] = 0.0
        key = jax.random.PRNGKey(trial)
        want = np.asarray(_jax_qsgd(jnp.asarray(x), key, level))
        uniform = torch.from_numpy(np.array(jax.random.uniform(key, x.shape)))
        got = tq.qsgd_quantize_dequantize(torch.from_numpy(x), uniform, level)
        assert got.numpy().tobytes() == want.tobytes(), (level, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nnadq_over_leaves_equals_leaf_by_leaf(seed):
    """The sessions' one-pass NNADQ over a message's leaves
    (``nnadq_quantize_dequantize_leaves``) is the one-leaf function on
    each, bit for bit: values and bit widths, over leaves of 1 to 20,000
    values, constant and zero ones among them."""
    rng = np.random.RandomState(seed)
    lengths = [int(rng.choice([1, 2, 3, 100, 1000, 4097, 20000])) for _ in range(25)]
    parts = []
    for n in lengths:
        kind = rng.randint(4)
        v = (rng.randn(n) * 10.0 ** rng.uniform(-5, 1)).astype(np.float32)
        if kind < 2:
            v[:] = (1.5, 0.0)[kind]  # a constant leaf, a zero one
        parts.append(v)
    x = torch.from_numpy(np.concatenate(parts))
    for weight in (0.01, 0.03, 0.5):
        out, bits = tq.nnadq_quantize_dequantize_leaves(x, lengths, weight)
        start = 0
        for i, n in enumerate(lengths):
            want, want_bits = tq.nnadq_quantize_dequantize(x[start : start + n], weight)
            assert out[start : start + n].numpy().tobytes() == want.numpy().tobytes(), (i, n, weight)
            assert float(bits[i]) == float(want_bits), (i, n, weight)
            start += n


@pytest.mark.parametrize("level", [255, 15])
def test_qsgd_over_leaves_equals_leaf_by_leaf(level):
    """The sessions' one-pass QSGD (``qsgd_quantize_dequantize_leaves``) is
    the one-leaf function on each leaf given the same uniforms, bit for
    bit, one-value leaves (their own association) and zero leaves among
    them."""
    rng = np.random.RandomState(level)
    lengths = [int(rng.choice([1, 2, 3, 100, 1000, 4097])) for _ in range(30)] + [1]
    parts = [(rng.randn(n) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32) for n in lengths]
    parts[3][:] = 0.0
    x = torch.from_numpy(np.concatenate(parts))
    uniform = torch.from_numpy(rng.uniform(size=x.numel()).astype(np.float32))
    out = tq.qsgd_quantize_dequantize_leaves(x, uniform, lengths, level)
    start = 0
    for i, n in enumerate(lengths):
        want = tq.qsgd_quantize_dequantize(x[start : start + n], uniform[start : start + n], level)
        assert out[start : start + n].numpy().tobytes() == want.numpy().tobytes(), (i, n)
        start += n


def test_jax_leaf_order_round_trips_a_convolution():
    """``JaxLeaf.to_jax`` puts a kernel's values in the JAX layout's flat
    order (HWIO), and ``from_jax`` takes them back."""
    conv = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    (leaf,) = convert.jax_leaves(["Conv_0.weight"], [tuple(conv.shape)])
    assert leaf.jax_key == "Conv_0/kernel"
    flat = leaf.to_jax(conv.reshape(-1))
    np.testing.assert_array_equal(flat.numpy(), convert.to_jax({"Conv_0.weight": conv})["Conv_0/kernel"].reshape(-1))
    assert torch.equal(leaf.from_jax(flat), conv.reshape(-1))


# ---------------------------------------------------------------- the JAX draws
class JaxSessionRandom(tq.CodecRandom):
    """The JAX sessions' own QSGD draws, from their key chains:

    * ``"obd"`` (``spmd_obd.py``): ``rng, round_rng, bcast_rng =
      split(rng, 3)`` an aggregate; slot ``s`` trains from
      ``split(round_rng, n_slots)[s]``, whose second half of a split is
      its codec key, folded with the leaf index; the broadcast folds
      ``bcast_rng``;
    * ``"paq"`` (``spmd.py``, fed_paq): ``rng, round_rng = split(rng)`` a
      round, ``fold_in(round_rng, s)`` a slot, the second half of its split
      split once per leaf.

    ``n_slots`` is the JAX session's slot count (the workers padded to the
    test mesh)."""

    def __init__(self, mode: str, seed: int, worker_number: int) -> None:
        self.mode = mode
        self.n_slots = client_slots(worker_number, make_mesh())
        self._chain = [jax.random.PRNGKey(seed)]
        self._rounds = []

    def _round(self, aggregate: int):
        while len(self._rounds) <= aggregate:
            if self.mode == "obd":
                rng, round_rng, bcast_rng = jax.random.split(self._chain[-1], 3)
            else:
                (rng, round_rng), bcast_rng = jax.random.split(self._chain[-1]), None
            self._chain.append(rng)
            self._rounds.append((round_rng, bcast_rng))
        return self._rounds[aggregate]

    def session_uniform(self, seed, aggregate, slot, leaf, count, shape, device):
        round_rng, bcast_rng = self._round(aggregate)
        if slot is None:
            key = jax.random.fold_in(bcast_rng, leaf)
        elif self.mode == "obd":
            client = jax.random.split(round_rng, self.n_slots)[slot]
            key = jax.random.fold_in(jax.random.split(client)[1], leaf)
        else:
            client = jax.random.fold_in(round_rng, slot)
            key = jax.random.split(jax.random.split(client)[1], count)[leaf]
        return torch.from_numpy(np.array(jax.random.uniform(key, tuple(shape))))


# ---------------------------------------------------------------- trajectories
def _fields(tmp_path, name, algorithm, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm=algorithm,
        worker_number=WORKERS,
        batch_size=8,
        round=ROUNDS,
        epoch=2,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
        algorithm_kwargs={} if algorithm == "fed_paq" else {"second_phase_epoch": TUNING, "dropout_rate": 0.5},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


#: the IMDB classifier at d_model 32, 2 heads, 2 layers over 16 tokens
TEXT = dict(
    dataset_name="imdb",
    model_name="TransformerClassificationModel",
    epoch=1,
    batch_size=16,
    dataset_kwargs={"max_len": 16, "vocab_size": 200, "train_size": 64, "val_size": 16, "test_size": 32},
    model_kwargs={"max_len": 16, "d_model": 32, "nhead": 2, "num_encoder_layer": 2},
)


def _no_text_dropout(monkeypatch) -> None:
    """The classifier's dropout (0.1; flax's threefry bits cannot be
    reproduced) set to 0 in both packages for this test only."""
    from distributed_learning_simulator_tpu.models import text as jtext
    from distributed_learning_simulator_tpu_torch.models import text as ttext

    class EncoderLayer(jtext.EncoderLayer):  # flax names a submodule by its class
        dropout_rate: float = 0.0

    class TorchEncoderLayer(ttext.EncoderLayer):
        def __init__(self, *args, dropout_rate: float = 0.0, **kwargs):
            super().__init__(*args, dropout_rate=dropout_rate, **kwargs)

    monkeypatch.setattr(jtext, "EncoderLayer", EncoderLayer)
    monkeypatch.setattr(ttext, "EncoderLayer", TorchEncoderLayer)


def _run_both(tmp_path, algorithm, random_client_number=None, **extra):
    """The JAX package's and the port's SPMD sessions from one JAX init;
    the port's QSGD fed the JAX draws.  Returns the configs, the results
    and the port's codec steps."""
    init_config = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "init", algorithm, **extra))
    ctx = j_create_model(init_config.model_name, j_create_dc(init_config), **init_config.model_kwargs)
    init = str(tmp_path / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()})
    kwargs = dict(_fields(tmp_path, "x", algorithm)["algorithm_kwargs"], global_model_path=init)
    if random_client_number:
        kwargs["random_client_number"] = random_client_number
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", algorithm, algorithm_kwargs=kwargs, **extra))
    mode = "paq" if algorithm == "fed_paq" else "obd"
    endpoint = {"worker": {"random": JaxSessionRandom(mode, jc.seed, WORKERS)}}
    tc = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "torch", algorithm, algorithm_kwargs=dict(kwargs), endpoint_kwargs=endpoint, **extra)
    )
    jc.load_config_and_process()
    tc.load_config_and_process()
    jres = jax_train(jc)["performance"]
    with chip_smoke.CodecSteps() as steps:
        tres = training.train(tc, device="cpu")["performance"]
    return jc, tc, jres, tres, steps


def _records(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


def _assert_trajectories_match(jc, tc, jres, tres, steps, phases) -> int:
    """Every record held; the final npz within rtol 1e-4 / atol 1e-5 but
    for elements a level flip apart: each must differ by what one flip of
    the last aggregate's codec moves it (``chip_smoke.CodecSteps.moves``),
    to 0.1% or to the same tolerance once the move is taken off.  Returns
    how many elements took such a flip."""
    assert sorted(tres) == sorted(jres) == list(range(1, len(phases) + 1))
    for key in jres:
        got, want = tres[key], jres[key]
        np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-4)
        assert got["test_accuracy"] == want["test_accuracy"]
        assert got.get("phase") == want.get("phase") == phases[key - 1]
        # equal bits: equal kept blocks and bit widths
        np.testing.assert_allclose(got["received_mb"], want["received_mb"], rtol=1e-6)
        np.testing.assert_allclose(got["sent_mb"], want["sent_mb"], rtol=1e-6)
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec)
    for key in jrec:
        assert set(jrec[key]) <= set(trec[key]), key  # the port adds test_count
    last = f"round_{len(phases)}.npz"
    with np.load(os.path.join(jc.save_dir, "aggregated_model", last)) as j, \
            np.load(os.path.join(tc.save_dir, "aggregated_model", last)) as t:
        assert sorted(t.files) == sorted(j.files)
        got, want = {k: t[k] for k in t.files}, {k: j[k] for k in j.files}
    masks = chip_smoke.flipped_elements(
        got, want, steps, len(phases) - 1, atol=1e-5, rtol=1e-4, match=1e-3, within_tolerance=True
    )
    flipped = sum(int(m.sum()) for m in masks.values())
    assert flipped <= 1e-3 * sum(v.size for v in want.values())
    return flipped


OBD_PHASES = ["block_dropout_rounds"] * ROUNDS + ["epoch_tune"] * TUNING


@pytest.mark.parametrize("selected", [None, 2], ids=["all", "two_selected"])
@pytest.mark.parametrize("family", ["lenet5", "text_classifier"])
def test_fed_obd_trajectory_matches_jax(tmp_path, monkeypatch, family, selected):
    extra = {}
    if family == "text_classifier":
        _no_text_dropout(monkeypatch)
        extra = TEXT
    jc, tc, jres, tres, steps = _run_both(tmp_path, "fed_obd", selected, **extra)
    stepped = _assert_trajectories_match(jc, tc, jres, tres, steps, OBD_PHASES)
    # NNADQ rounds deterministically: an element flips only on a level
    # boundary (1 element, in the classifier's run with 2 selected)
    print(f"fed_obd {family} selected={selected}: {stepped} elements a level flip apart")


@pytest.mark.parametrize(
    "algorithm,selected",
    [("fed_obd_sq", None), ("fed_obd_sq", 2), ("fed_paq", None), ("fed_paq", 2)],
)
def test_qsgd_trajectory_matches_jax_with_its_draws(tmp_path, algorithm, selected):
    jc, tc, jres, tres, steps = _run_both(tmp_path, algorithm, selected)
    phases = OBD_PHASES if algorithm == "fed_obd_sq" else [None] * ROUNDS
    stepped = _assert_trajectories_match(jc, tc, jres, tres, steps, phases)
    # a value whose rounding probability sits on its uniform draw (none here)
    print(f"{algorithm} selected={selected}: {stepped} elements a level flip apart")


# ---------------------------------------------------------------- DenseNet-40
def _densenet_session(tmp_path, algorithm="fed_obd", **algorithm_kwargs):
    config = tconfig.DistributedTrainingConfig(
        dataset_name="CIFAR10",
        model_name="densenet40",
        distributed_algorithm=algorithm,
        worker_number=2,
        batch_size=2,
        round=1,
        epoch=1,
        dataset_kwargs={"train_size": 4, "val_size": 2, "test_size": 2},
        algorithm_kwargs={"second_phase_epoch": 1, "dropout_rate": 0.9, **algorithm_kwargs},
        endpoint_kwargs={"worker": {"weight": 0.01}},
        save_dir=str(tmp_path / "densenet"),
    )
    return training.build_session(config, device="cpu")


def test_densenet40_blocks_match_jax(tmp_path):
    """The port's blocks of DenseNet-40, in JAX keys, are JAX
    ``get_module_blocks``'s over the JAX model's own parameter names."""
    session = _densenet_session(tmp_path)
    jc = jconfig.DistributedTrainingConfig(
        dataset_name="CIFAR10", model_name="densenet40", dataset_kwargs={"train_size": 4, "val_size": 2, "test_size": 2}
    )
    jctx = j_create_model("densenet40", j_create_dc(jc))
    template = jax.eval_shape(lambda: JaxEngine(jctx, JaxHP(), total_steps=1).init_params(0))
    leaves = session._jax_leaves
    assert [leaf.jax_key for leaf in leaves] == sorted(template)
    for leaf in leaves:
        assert tuple(leaf.shape[p] for p in (leaf.perm or range(len(leaf.shape)))) == template[leaf.jax_key].shape
    jblocks = jobd.get_module_blocks(list(template))
    tblocks = [[] for _ in jblocks]
    for leaf, block in zip(leaves, session._leaf_block):
        tblocks[block].append(leaf.jax_key)
    assert tblocks == jblocks
    assert len(jblocks) > 10
    np.testing.assert_array_equal(session._block_sizes, [sum(int(np.prod(template[k].shape)) for k in b) for b in jblocks])


def _jax_keep_mask(local: dict, global_params: dict, blocks, threshold: float) -> np.ndarray:
    """The JAX session's greedy selection (``spmd_obd.py::keep_mask``),
    over a dict of JAX arrays."""
    block_id = {k: i for i, block in enumerate(blocks) for k in block}
    sizes = np.zeros(len(blocks), np.float32)
    for k, v in global_params.items():
        sizes[block_id[k]] += v.size
    block_sizes = jnp.asarray(sizes)
    sq = jnp.zeros(len(blocks))
    for k in sorted(local):
        d = local[k].astype(jnp.float32) - global_params[k].astype(jnp.float32)
        sq = sq.at[block_id[k]].add(jnp.sum(jnp.square(d)))
    score = jnp.sqrt(sq) / block_sizes
    order = jnp.argsort(-score)

    def body(partial, size_i):
        keep = partial + size_i <= threshold
        return partial + size_i * keep, keep

    _, keep_ord = jax.lax.scan(body, jnp.float32(0.0), block_sizes[order])
    return np.asarray(jnp.zeros(len(blocks), bool).at[order].set(keep_ord))


def test_densenet40_phase1_upload_matches_a_jax_per_leaf_reference(tmp_path):
    """A seeded perturbation of DenseNet-40's init (each leaf moved at its
    own scale) through the port's phase-1 upload against the reference:
    kept blocks by the JAX selection, kept leaves ``g + nnadq(p - g)`` by
    JAX ``nnadq_quantize_dequantize``, dropped leaves the broadcast, and
    ``upload_bits`` summed in f32 in leaf order."""
    session = _densenet_session(tmp_path)
    g = session._init_global_params()
    rng = np.random.RandomState(7)
    noise = torch.cat([
        torch.from_numpy((rng.randn(leaf.size) * 10.0 ** rng.uniform(-4, -1)).astype(np.float32))
        for leaf in sorted(session._jax_leaves, key=lambda leaf: leaf.start)
    ])
    p = g + noise
    row = torch.empty_like(g)
    bits = session._obd_upload(row, p, g, phase_two=False, aggregate=0, slot=0)

    layout = session.engine.layout
    jg = {k: jnp.asarray(v) for k, v in convert.to_jax(layout.split(g)).items()}
    jp = {k: jnp.asarray(v) for k, v in convert.to_jax(layout.split(p)).items()}
    blocks = jobd.get_module_blocks(list(jg))
    threshold = (1.0 - 0.9) * float(session._block_sizes.sum())
    keep = _jax_keep_mask(jp, jg, blocks, threshold)
    block_id = {k: i for i, block in enumerate(blocks) for k in block}

    @jax.jit
    def reference(jp, jg, masks):
        """The JAX session's phase-1 upload (``spmd_obd.py:474-492``)."""
        upload, bits = {}, jnp.float32(0.0)
        for k in sorted(jg):
            dq, leaf_bits = jq.nnadq_quantize_dequantize(jp[k] - jg[k], 0.01)
            upload[k] = jnp.where(masks[k], jg[k] + dq, jg[k])
            bits += masks[k] * leaf_bits * jg[k].size
        return upload, bits

    masks = {k: jnp.asarray(keep[block_id[k]]) for k in jg}
    want, want_bits = reference(jp, jg, masks)
    got = convert.to_jax(layout.split(row))
    kept = sum(bool(m) for m in masks.values())
    for k in sorted(jg):
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k
    assert 0 < kept < len(jg)
    np.testing.assert_array_equal(session.keep_blocks(p - g), keep)
    assert float(bits) == float(want_bits)


# ---------------------------------------------------------------- session units
def test_k1_launches_follow_the_aggregates(tmp_path, monkeypatch):
    """K1 runs once a chunk each aggregate (``chip_smoke.expected_obd_k1``):
    2 rounds and 2 tuning epochs of 4 slots in chunks of 2."""
    calls = []
    aggregate = spmd_obd.flat_stack_weighted_sum

    def counted(rows, w):
        calls.append(rows.shape[0])
        return aggregate(rows, w)

    monkeypatch.setattr(spmd_obd, "flat_stack_weighted_sum", counted)
    kwargs = {"second_phase_epoch": TUNING, "dropout_rate": 0.5, "client_chunk": 2, "random_client_number": 2}
    config = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "k1", "fed_obd", epoch=1, algorithm_kwargs=kwargs))
    session = training.build_session(config, device="cpu")
    perf = session.run()["performance"]
    assert [row["phase"] for _, row in sorted(perf.items())] == OBD_PHASES
    assert len(calls) == chip_smoke.expected_obd_k1(len(perf), session.n_slots, session.chunk_size()) == 8
    assert set(calls) == {2}
    assert os.path.exists(os.path.join(config.save_dir, "aggregated_model", f"round_{len(perf)}.npz"))


def test_phase_two_seeds_from_the_last_participation(tmp_path):
    """With 2 of 4 clients a round, a slot never selected enters phase 2
    with a fresh optimizer, and every phase-2 epoch advances each slot's
    carried schedule by its steps."""
    kwargs = {"second_phase_epoch": 1, "dropout_rate": 0.5, "random_client_number": 2}
    config = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "carry", "fed_obd", round=1, epoch=1, algorithm_kwargs=kwargs)
    )
    session = training.build_session(config, device="cpu")
    g = session._init_global_params()
    weights = session._base_weight_row(1)
    session.run_aggregate(g, weights, 1, phase_two=False)
    steps = [sum(1 for n in counts if n > 0) for counts in session._counts]
    for slot in range(WORKERS):
        state = session._opt_states[slot]
        assert (state is not None) == (weights[slot] > 0)
        if state is not None:
            assert state.count == steps[slot]
    counts_before = [s.count if s is not None else 0 for s in session._opt_states]
    session.run_aggregate(g, session._all_weights(), 2, phase_two=True)
    assert [s.count for s in session._opt_states] == [c + n for c, n in zip(counts_before, steps)]


def test_obd_session_raises_without_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "nocuda", "fed_obd"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.train(config)


@pytest.mark.parametrize(
    "change",
    [
        # round_horizon runs; with the streamed population store (which
        # large_scale/fed_avg/mnist_streamed_population.yaml pairs it with) it does not
        {"algorithm_kwargs": {"second_phase_epoch": 1, "dropout_rate": 0.5, "round_horizon": 2,
                              "population_store": "streamed"}},
        {"algorithm_kwargs": {"second_phase_epoch": 1, "dropout_rate": 0.5, "selection_gather": True}},
        # resume runs (tests/test_torch_resume.py), and so does the fault plan
        {"algorithm_kwargs": {"second_phase_epoch": 1, "dropout_rate": 0.5, "resume_dir": "x"},
         "fault_tolerance": {"dropout_rate": 0.5}},
        {"fault_tolerance": {"update_guard": True}},
    ],
    ids=["round_horizon", "selection_gather", "resume", "fault_tolerance"],
)
def test_unported_obd_options_raise(tmp_path, change):
    """What FedOBD's session still refuses raises; the fault plan, which it
    now runs (a resume of a directory with nothing in it is a fresh run),
    is held against the JAX session from its init: the guard as every
    trajectory here; the seeded dropout (aggregates of one or two
    clients) by its phases, wire MB and accuracies, and its test losses at
    rtol 1e-3: a level flip in the broadcast of such an aggregate moves
    the next aggregate's loss by up to 2.5e-4 (ROADMAP R10)."""
    if "fault_tolerance" in change:
        jc, tc, jres, tres, steps = _run_both(tmp_path, "fed_obd", fault_tolerance=change["fault_tolerance"])
        if "update_guard" in change["fault_tolerance"]:
            _assert_trajectories_match(jc, tc, jres, tres, steps, OBD_PHASES)
            return
        assert sorted(tres) == sorted(jres) == list(range(1, len(OBD_PHASES) + 1))
        for key, want in jres.items():
            got = tres[key]
            assert got["phase"] == want["phase"] == OBD_PHASES[key - 1]
            assert got["test_accuracy"] == want["test_accuracy"]
            np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-3)
            np.testing.assert_allclose(got["received_mb"], want["received_mb"], rtol=1e-6)
            np.testing.assert_allclose(got["sent_mb"], want["sent_mb"], rtol=1e-6)
        return
    config = tconfig.DistributedTrainingConfig(**{**_fields(tmp_path, "refused", "fed_obd"), **change})
    with pytest.raises(NotImplementedError):
        training.train(config, device="cpu")


@pytest.mark.parametrize(
    "accuracies",
    [[0.1] * 3, [0.1, 0.2, 0.3, 0.3, 0.3, 0.3], [0.1, 0.5, 0.2, 0.2, 0.2, 0.2, 0.2], [0.5, 0.1, 0.1, 0.1, 0.1, 0.6]],
    ids=["short", "improving", "plateau", "late_gain"],
)
def test_early_stop_plateau_rule_matches_jax(accuracies):
    """``early_stop``'s 5-point plateau test on the recorded accuracies,
    the port's against the JAX session's on the same records."""
    from distributed_learning_simulator_tpu.parallel import spmd_obd as jspmd_obd

    class Records:
        _stat = {i + 1: {"test_accuracy": a} for i, a in enumerate(accuracies)}

    want = jspmd_obd.SpmdFedOBDSession._has_improvement(Records())
    assert spmd_obd.SpmdFedOBDSession._has_improvement(Records()) == want
    assert want == (len(accuracies) < 6 or max(accuracies[-5:]) > max(accuracies[:-5]))
