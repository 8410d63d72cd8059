"""The port's threaded executor (``executor: sequential``) for fed_paq,
FedDropoutAvg, SMAFD and sign_SGD against the JAX package's, and the
pieces under them.

* fed_paq, fed_dropout_avg and single_model_afd on LeNet5/MNIST (2
  workers, 2 rounds of 2 local epochs: the best-epoch validation runs),
  from one JAX init: the port fed the JAX threaded run's own draws
  (:class:`JaxSparseRandom`, the JAX key chain the threaded worker's
  aligned stream reserves) against the JAX threaded run, and the port's
  threaded run against the port's SPMD session (its own draws): final
  test loss within atol 1e-5, accuracy equal, the final aggregates within
  atol 1e-5 (the bound of JAX's ``tests/test_executor_matrix.py``).
* sign_SGD, 1 round of 2 epochs, both packages from the JAX init: the
  record within ``RUN_RTOL`` (``tests/test_torch_sign_sgd.py``'s bound for
  whole runs through vote flips).
* The per-step hooks fire once a batch with the JAX trainer's keyword
  arguments; a per-step epoch without an ``OPTIMIZER_STEP`` hook, and an
  epoch without hooks, are ``engine.train_epoch`` bit for bit.
* ``NNADQ`` blobs and decodes bit-equal to the JAX codec's; the random
  whole-tensor dropout and SMAFD's top-k keep JAX's tensors and elements.
* A threaded ``train()`` of each new method raises without CUDA unless
  ``device="cpu"`` is passed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.algorithm import random_dropout_algorithm as jrda
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine import executor as jexecutor
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.method.smafd import worker as jsmafd
from distributed_learning_simulator_tpu.ml_type import ExecutorHookPoint as JaxPoint
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.ops import quantization as jq
from distributed_learning_simulator_tpu.topology.quantized_endpoint import _EncodedPayload as JaxPayload
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.algorithm.random_dropout_algorithm import RandomDropoutAlgorithm
from distributed_learning_simulator_tpu_torch.engine.engine import ComputeEngine
from distributed_learning_simulator_tpu_torch.engine.executor import Trainer
from distributed_learning_simulator_tpu_torch.method.smafd.worker import SingleModelAFDWorker
from distributed_learning_simulator_tpu_torch.ml_type import ExecutorHookPoint
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.models.dropout import dropout_generator
from distributed_learning_simulator_tpu_torch.ops import quantization as tq

from test_torch_sign_sgd import RUN_RTOL
from test_torch_sparse import JaxSparseRandom

ROUNDS = 2
WORKERS = 2
SIZES = {"train_size": 48, "val_size": 16, "test_size": 32}
#: the methods whose two executors draw alike, and their algorithm_kwargs
TIGHT = {
    "fed_paq": {},
    "fed_dropout_avg": {"dropout_rate": 0.3},
    "single_model_afd": {"dropout_rate": 0.3},
}


def _fields(tmp_path, name, algorithm, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm=algorithm,
        executor="sequential",
        worker_number=WORKERS,
        batch_size=8,
        round=ROUNDS,
        epoch=2,
        learning_rate=0.05,
        dataset_kwargs=dict(SIZES),
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


def _jax_init(fields) -> dict:
    jc = jconfig.DistributedTrainingConfig(**fields)
    ctx = j_create_model(fields["model_name"], j_create_dc(jc))
    return {k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()}


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("threaded_init") / "init.npz"
    np.savez(path, **_jax_init(_fields(path.parent, "init", "fed_avg")))
    return str(path)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, init_npz):
    """Each tight method's JAX threaded run, once: ``(config, records)``."""
    runs = {}

    def run(method):
        if method not in runs:
            tmp = tmp_path_factory.mktemp(f"jax_{method}")
            kwargs = dict(TIGHT[method], global_model_path=init_npz)
            jc = jconfig.DistributedTrainingConfig(**_fields(tmp, "jax", method, algorithm_kwargs=kwargs))
            runs[method] = (jc, jax_train(jc)["performance"])
        return runs[method]

    return run


def _port(tmp_path, name, method, init, random=None, **extra):
    fields = _fields(tmp_path, name, method, algorithm_kwargs=dict(TIGHT[method], global_model_path=init), **extra)
    if random is not None:
        fields["endpoint_kwargs"] = {"worker": {"random": random}}
    config = tconfig.DistributedTrainingConfig(**fields)
    return config, training.train(config, device="cpu")["performance"]


def _final(config) -> dict:
    with np.load(os.path.join(config.save_dir, "aggregated_model", f"round_{ROUNDS}.npz")) as blob:
        return {k: blob[k] for k in blob.files}


def _assert_tight(got_config, got, want_config, want) -> None:
    """The final test loss within atol 1e-5 and the same accuracy; the
    final aggregates' elements within atol 1e-5 but for QSGD's level flips
    (ROADMAP R10: an upload element whose ``|x| / scale * level`` sits
    within f32 rounding of its draw rounds either way, a move of one level
    step), counted and held to a few per 10,000."""
    assert sorted(got) == sorted(want) == list(range(1, ROUNDS + 1))
    np.testing.assert_allclose(got[ROUNDS]["test_loss"], want[ROUNDS]["test_loss"], rtol=0, atol=1e-5)
    assert got[ROUNDS]["test_accuracy"] == pytest.approx(want[ROUNDS]["test_accuracy"], abs=1e-6)
    a, b = _final(got_config), _final(want_config)
    assert sorted(a) == sorted(b)
    apart = sum(int((np.abs(a[k] - b[k]) > 1e-5).sum()) for k in b)
    size = sum(v.size for v in b.values())
    worst = max(float(np.abs(a[k] - b[k]).max()) for k in b)
    print(f"{got_config.distributed_algorithm}: {apart} of {size} elements beyond 1e-5, at most {worst:.3g} apart")
    if got_config.distributed_algorithm != "fed_paq":
        assert apart == 0
    assert apart <= 5e-4 * size and worst <= 1e-3


@pytest.mark.parametrize("method", sorted(TIGHT))
def test_threaded_matches_jax_threaded(tmp_path, init_npz, jax_runs, method):
    """The port's worker keys its upload with the round's
    ``SessionKey``; fed the JAX draws for those requests it makes the
    JAX threaded run's uploads: the same trajectory up to summation
    order, and the same wire bytes."""
    jc, jres = jax_runs(method)
    tc, tres = _port(tmp_path, "torch", method, init_npz, random=JaxSparseRandom(jc.seed, WORKERS))
    _assert_tight(tc, tres, jc, jres)
    for key in jres:
        np.testing.assert_allclose(tres[key]["received_mb"], jres[key]["received_mb"], rtol=1e-6)
        np.testing.assert_allclose(tres[key]["sent_mb"], jres[key]["sent_mb"], rtol=1e-6)


@pytest.mark.parametrize("method", sorted(TIGHT))
def test_threaded_matches_port_spmd(tmp_path, init_npz, method):
    """The port's two executors draw the same values for a (round, slot)
    (``CodecRandom``), so they train one trajectory."""
    sc, spmd = _port(tmp_path, "spmd", method, init_npz, executor="spmd")
    tc, threaded = _port(tmp_path, "threaded", method, init_npz)
    _assert_tight(tc, threaded, sc, spmd)


def test_sign_sgd_matches_jax_threaded(tmp_path, monkeypatch):
    """Both packages' gradient workers from the JAX init (neither reads
    ``global_model_path``): a vote a step through the server, the update
    on the worker."""
    fields = _fields(tmp_path, "sign", "sign_SGD", round=1, learning_rate=0.01, distribute_init_parameters=False)
    init = _jax_init(fields)
    monkeypatch.setattr(ComputeEngine, "init_params", lambda self, seed: convert.from_jax(init))
    jc = jconfig.DistributedTrainingConfig(**dict(fields, save_dir=str(tmp_path / "jax")))
    jres = jax_train(jc)["performance"]
    tc = tconfig.DistributedTrainingConfig(**dict(fields, save_dir=str(tmp_path / "torch")))
    tres = training.train(tc, device="cpu")["performance"]
    assert sorted(tres) == sorted(jres) == [1]
    got, want = tres[1], jres[1]
    print(f"threaded sign_SGD test loss {got['test_loss']:.6f} (JAX {want['test_loss']:.6f})")
    assert abs(got["test_loss"] - want["test_loss"]) <= RUN_RTOL * abs(want["test_loss"])
    assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 2 / SIZES["test_size"]
    assert os.path.isfile(os.path.join(tc.save_dir, "worker_0", "epoch_stat.json"))


@pytest.mark.parametrize("method", ["fed_paq", "fed_dropout_avg", "single_model_afd", "sign_SGD", "fed_obd"])
def test_threaded_train_raises_without_cuda_unless_cpu_is_asked(tmp_path, monkeypatch, method):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = {"second_phase_epoch": 1, "dropout_rate": 0.5} if method == "fed_obd" else TIGHT.get(method, {})
    config = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "nocuda", method, algorithm_kwargs=kwargs))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.train(config)


# ---------------------------------------------------------------- the trainer
def _port_trainer(tmp_path, init: dict) -> Trainer:
    """A port trainer over the task's whole training split, from ``init``."""
    ctx = training.build_task(tconfig.DistributedTrainingConfig(**_fields(tmp_path, "hooks", "fed_avg", epoch=1)),
                              device="cpu")
    trainer = Trainer(ctx.config, ctx.dataset_collection, ctx.model_ctx, ctx.engine, seed=1, name="t")
    trainer.load_parameter_dict(convert.from_jax(init))
    return trainer


def _jax_trainer(tmp_path, init: dict):
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "hooks", "fed_avg", epoch=1))
    jdc = j_create_dc(jc)
    jctx = j_create_model("LeNet5", jdc)
    jtrainer = jexecutor.Trainer(jc, jdc, jctx, JaxEngine(jctx, JaxHP.from_config(jc), total_steps=8), seed=1)
    jtrainer.load_parameter_dict({k: jnp.asarray(v) for k, v in init.items()})
    return jtrainer


def _recorder(calls, points):
    def hook(executor, hook_point, **kwargs):
        calls.append((points[hook_point], tuple(sorted(kwargs)), kwargs["epoch"], kwargs["batch_index"]))

    return hook


def test_per_step_hooks_fire_once_a_batch_with_the_jax_arguments(tmp_path):
    init = _jax_init(_fields(tmp_path, "init", "fed_avg"))
    trainer, jtrainer = _port_trainer(tmp_path, init), _jax_trainer(tmp_path, init)
    calls = {"port": [], "jax": []}
    for side, t, points in (("port", trainer, ExecutorHookPoint), ("jax", jtrainer, JaxPoint)):
        names = {points.BEFORE_BATCH: "before", points.OPTIMIZER_STEP: "step", points.AFTER_BATCH: "after"}
        for point in names:
            t.append_named_hook(point, "rec", _recorder(calls[side], names))
    start = trainer.vec.clone()
    trainer.train()
    jtrainer.train()
    n_batches = len(trainer.epoch_batches(trainer.phase, None)[1])
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == 3 * n_batches
    assert calls["port"][1] == ("step", ("batch", "batch_index", "epoch", "step_rng"), 1, 0)
    assert torch.equal(trainer.vec, start)  # the OPTIMIZER_STEP hook owns the update


def test_per_step_epoch_without_a_step_hook_is_train_epoch_bit_for_bit(tmp_path):
    init = _jax_init(_fields(tmp_path, "init", "fed_avg"))
    trainer, plain = _port_trainer(tmp_path, init), _port_trainer(tmp_path, init)
    start = trainer.vec.clone()
    seen = []
    trainer.append_named_hook(ExecutorHookPoint.AFTER_BATCH, "rec", lambda **kw: seen.append(kw["batch_size"]))
    trainer.train()
    plain.train()  # no hooks: engine.train_epoch
    batches, counts = plain.epoch_batches(plain.phase, plain._seed * 100003 + 1)
    by_hand = start.clone()
    opt = plain.engine.init_opt_state(by_hand)
    plain.engine.train_epoch(by_hand, opt, batches, counts, dropout_generator(plain._seed, 1, 0x5EED, "cpu"))
    assert seen == [float(c) for c in counts]
    assert torch.equal(trainer.vec, plain.vec) and torch.equal(plain.vec, by_hand)
    assert trainer.performance_metric.last["loss"] == plain.performance_metric.last["loss"]


# ---------------------------------------------------------------- the codecs
def _tree(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    shapes = [((4097,), 0.05), ((30, 40), 1.0), ((7,), 0.3), ((1,), 1.0), ((200, 300), 0.02), ((5, 5), 0.0)]
    return {f"leaf_{i}": (rng.randn(*s) * scale + rng.randn() * 0.1).astype(np.float32)
            for i, (s, scale) in enumerate(shapes)}


@pytest.mark.parametrize("flat", [False, True], ids=["per_leaf", "flat"])
@pytest.mark.parametrize("weight", [0.01, 0.001])
def test_nnadq_blobs_match_jax(flat, weight):
    tree = _tree(int(weight * 1000) + flat)
    jblob = jq.NNADQ(weight).quant({k: jnp.asarray(v) for k, v in tree.items()}, flat=flat)
    tblob = tq.NNADQ(weight).quant({k: torch.from_numpy(v) for k, v in tree.items()}, flat=flat)
    assert len(jblob["leaves"]) == len(tblob["leaves"]) == (1 if flat else len(tree))
    for je, te in zip(jblob["leaves"], tblob["leaves"]):
        assert je["bits"] == te["bits"]
        assert np.asarray(je["packed"]).astype(np.int64).tobytes() == te["packed"].numpy().tobytes()
        assert np.float32(je["lo"]).tobytes() == te["lo"].numpy().tobytes()
        assert np.float32(je["span"]).tobytes() == te["span"].numpy().tobytes()
    jout = jq.NNADQ(weight).dequant(jblob)
    tout = tq.NNADQ(weight).dequant(tblob)
    for key in tree:
        assert np.asarray(jout[key]).tobytes() == tout[key].numpy().tobytes(), key
    assert tq.blob_nbytes(tblob) == JaxPayload(jblob).nbytes
    original = {k: torch.from_numpy(v) for k, v in tree.items()}
    assert tq.check_compression_ratio(original, tblob) == jq.check_compression_ratio(
        {k: jnp.asarray(v) for k, v in tree.items()}, jblob
    )


@pytest.mark.parametrize("bits", [2, 8, 16])
def test_nnadq_decode_rounds_once_like_jax(bits):
    """Decodes whose exact value lies a hair off the midpoint of two f32
    values (``lo`` tiny against the span, where rounding through f64
    first would break the tie the other way) and random levels, spans and
    ``lo``: bit for bit the JAX jitted decode."""
    levels = (1 << bits) - 1
    step = np.float32(1.0 + 2.0**-23)  # 3 · step lies halfway between two f32 values
    span = np.nextafter(np.float32(levels), np.float32(levels + 1))
    while np.float32(span * (np.float32(1.0) / np.float32(levels))) != step:
        span = np.nextafter(span, np.float32(levels + 1))
    rng = np.random.RandomState(bits)
    cases = [(np.full(64, 3), span, lo) for lo in (np.float32(-(2.0**-60)), np.float32(2.0**-60))]
    cases.append((rng.randint(0, levels + 1, 4096), np.float32(1.0), np.float32(1e-9)))
    cases += [(rng.randint(0, levels + 1, 4096), np.float32(rng.rand() * 10.0**e), np.float32(rng.randn() * 10.0**e))
              for e in (-3, 0, 1)]
    for q, span_, lo in cases:
        packed = tq._pack_uint(torch.from_numpy(q), bits)
        want = jq._adq_decode_leaf(jnp.asarray(packed.numpy().astype(np.uint32)), jnp.float32(lo), jnp.float32(span_),
                                   bits, q.size)
        got = tq.NNADQ._decode_leaf(packed, torch.tensor(lo), torch.tensor(span_), bits, q.size)
        assert np.asarray(want).tobytes() == got.numpy().tobytes(), (span_, lo)


def test_random_dropout_keeps_the_jax_tensors():
    tree = {f"t{i}": np.zeros(n, np.float32) for i, n in enumerate([50, 7, 300, 12, 90, 1, 64])}
    for seed in range(5):
        want = jrda.RandomDropoutAlgorithm(0.4, seed=seed).drop_parameters(
            {k: jnp.asarray(v) for k, v in tree.items()}
        )
        got = RandomDropoutAlgorithm(0.4, seed=seed).drop_parameters({k: torch.from_numpy(v) for k, v in tree.items()})
        assert list(got) == list(want)


def test_smafd_topk_keeps_the_jax_elements(tmp_path):
    """Exact k a leaf, ties to the lower index of the JAX layout (a
    transposed kernel included), as the JAX worker's native top-k."""
    ctx = training.build_task(
        tconfig.DistributedTrainingConfig(**_fields(tmp_path, "topk", "fed_avg")), device="cpu"
    )
    rng = np.random.RandomState(3)
    delta = {k: torch.from_numpy(np.round(rng.randn(*v.shape), 1).astype(np.float32))
             for k, v in ctx.model_ctx.module.state_dict().items()}

    class Worker:
        _topk_ratio = 0.1
        trainer = type("T", (), {"engine": ctx.engine})

    Worker._leaves = SingleModelAFDWorker._leaves
    sent = SingleModelAFDWorker._topk_sparsify(Worker(), delta)
    jworker = jsmafd.SingleModelAFDWorker.__new__(jsmafd.SingleModelAFDWorker)
    jworker._topk_ratio = 0.1
    jsent, _ = jworker._topk_sparsify({k: jnp.asarray(v) for k, v in convert.to_jax(delta).items()})
    got = convert.to_jax(sent)
    assert sorted(got) == sorted(jsent)
    for key in jsent:
        assert np.asarray(jsent[key]).tobytes() == got[key].tobytes(), key
