"""The port's threaded executor (``executor: sequential``) against the JAX
package's.

* fed_avg: the JAX package's threaded run and the port's SPMD session
  against the port's threaded run, from one JAX init (``vit_tiny``, 2
  workers, 2 rounds of 2 epochs): final test loss within atol 1e-5 and the
  same accuracy, the bound JAX's own ``test_fed_avg_executors_match_tightly``
  holds its two executors to.
* fed_obd_sq with ``flat_payload: false`` on both sides, the only path
  on which the JAX package reaches its QSGD kernels K2/K3: the JAX side
  with ``use_pallas=True`` (patched into its quantized endpoint inside the
  test; no file changes) and its kernels under Pallas' generic
  interpreter, the port with a random source that returns the JAX draws.  ``LongContextTransformer`` at d_model 32 has a 640,000-value
  embedding, so every encode of it takes the K2 route.  Round 1 within
  atol 1e-5, every record within 5e-3 (the bound of JAX's
  ``test_fed_obd_sq_round1_parity_and_bounded_drift``).
* The launches of K2/K3 on a run follow the count ``chip_smoke.py``
  derives from the protocol; a failing worker fails the run; the FedOBD
  driver and block selection agree with the JAX package's.
"""

import functools
import json
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine import batching as jbatching
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.method.fed_obd import driver as jdriver
from distributed_learning_simulator_tpu.method.fed_obd import obd_algorithm as jobd
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.ops import pallas_kernels as pk
from distributed_learning_simulator_tpu.ops import quantization as jq
from distributed_learning_simulator_tpu.topology import quantized_endpoint as jqe
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.data import create_dataset_collection as t_create_dc
from distributed_learning_simulator_tpu_torch.engine import batching as tbatching
from distributed_learning_simulator_tpu_torch.engine.executor import Trainer
from distributed_learning_simulator_tpu_torch.method.fed_obd import driver as tdriver
from distributed_learning_simulator_tpu_torch.method.fed_obd import obd_algorithm as tobd
from distributed_learning_simulator_tpu_torch.ml_type import MachineLearningPhase as Phase
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.ops import qsgd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the launch-count derivation under test)
from test_torch_qsgd import JaxCodecRandom  # noqa: E402

ROUNDS = 2


def _init_npz(path, model: str, fields: dict, width: dict) -> str:
    """The JAX engine's init params for the task, as an npz."""
    jc = jconfig.DistributedTrainingConfig(**fields)
    ctx = j_create_model(model, j_create_dc(jc), **width)
    params = JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return str(path)


def _records(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


# ---------------------------------------------------------------- fed_avg
def _avg_fields(tmp_path, name, **extra):
    fields = dict(
        dataset_name="CIFAR10",
        model_name="vit_tiny",
        distributed_algorithm="fed_avg",
        executor="sequential",
        worker_number=2,
        batch_size=16,
        round=ROUNDS,
        epoch=2,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


@pytest.fixture(scope="module")
def avg_init(tmp_path_factory):
    path = tmp_path_factory.mktemp("avg_init") / "init.npz"
    return _init_npz(path, "vit_tiny", _avg_fields(path.parent, "init"), {})


def _port_avg(tmp_path, avg_init, name, **extra):
    config = tconfig.DistributedTrainingConfig(
        **_avg_fields(tmp_path, name, algorithm_kwargs={"global_model_path": avg_init}, **extra)
    )
    return config, training.train(config, device="cpu")["performance"]


def _assert_final_match(got: dict, want: dict) -> None:
    last = max(want)
    assert sorted(got) == sorted(want) == list(range(1, ROUNDS + 1))
    np.testing.assert_allclose(got[last]["test_loss"], want[last]["test_loss"], rtol=0, atol=1e-5)
    assert got[last]["test_accuracy"] == pytest.approx(want[last]["test_accuracy"], abs=1e-6)


def test_threaded_fed_avg_matches_jax_threaded(tmp_path, avg_init):
    """Both threaded executors train the SPMD session's stream (sampler-
    order batches, each worker's best validation epoch uploaded under iid)
    and aggregate by dataset size: the same trajectory up to summation
    order."""
    jc = jconfig.DistributedTrainingConfig(
        **_avg_fields(tmp_path, "jax", algorithm_kwargs={"global_model_path": avg_init})
    )
    jres = jax_train(jc)["performance"]
    tc, tres = _port_avg(tmp_path, avg_init, "torch")
    _assert_final_match(tres, jres)
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec)
    for key in jrec:
        # the port records the same fields, plus test_count
        assert set(jrec[key]) <= set(trec[key]), key
    path = os.path.join("aggregated_model", f"round_{ROUNDS}.npz")
    with np.load(os.path.join(jc.save_dir, path)) as j, np.load(os.path.join(tc.save_dir, path)) as t:
        assert sorted(t.files) == sorted(j.files)
        for key in j.files:
            np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-5, err_msg=key)


def test_threaded_fed_avg_matches_port_spmd(tmp_path, avg_init):
    _, spmd = _port_avg(tmp_path, avg_init, "spmd", executor="spmd")
    _, threaded = _port_avg(tmp_path, avg_init, "threaded")
    _assert_final_match(threaded, spmd)


def test_make_epoch_batches_shuffle_is_byte_equal():
    """The threaded trainer's per-epoch shuffle draws the JAX package's
    order from the same ``default_rng`` seed."""
    config = tconfig.DistributedTrainingConfig(
        dataset_name="CIFAR10", dataset_kwargs={"train_size": 40, "val_size": 8, "test_size": 8}
    )
    jc = jconfig.DistributedTrainingConfig(
        dataset_name="CIFAR10", dataset_kwargs={"train_size": 40, "val_size": 8, "test_size": 8}
    )
    tds = t_create_dc(config).get_dataset(Phase.Training)
    jds = j_create_dc(jc).get_dataset(jbatching.Phase.Training)
    for seed in (0, 100003 * 3 + 2):
        want = jbatching.make_epoch_batches(jds, 16, np.random.default_rng(seed))
        got = tbatching.make_epoch_batches(tds, 16, np.random.default_rng(seed))
        for key in ("input", "target", "mask"):
            assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes(), key


# ---------------------------------------------------------------- fed_obd_sq
OBD_TEXT = dict(max_len=64, train_size=24, val_size=8, test_size=16)
OBD_WIDTH = dict(d_model=32, nhead=2, num_encoder_layer=1, max_len=64, dropout_rate=0.0)
PER_LEAF = {"worker": {"flat_payload": False}, "server": {"flat_payload": False}}


def _obd_fields(tmp_path, name, workers=2, **extra):
    fields = dict(
        dataset_name="imdb",
        model_name="LongContextTransformer",
        distributed_algorithm="fed_obd_sq",
        executor="sequential",
        worker_number=workers,
        batch_size=4,
        round=ROUNDS,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs=dict(OBD_TEXT),
        model_kwargs=dict(OBD_WIDTH),
        algorithm_kwargs={"second_phase_epoch": 2, "dropout_rate": 0.5},
        endpoint_kwargs={k: dict(v) for k, v in PER_LEAF.items()},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


class _Counted:
    """Counts the calls of the port's K2/K3 wrappers (on the CPU they
    compute the plain versions)."""

    def __init__(self, monkeypatch) -> None:
        self.encode = self.decode = 0
        encode, decode = qsgd.qsgd_encode, qsgd.qsgd_decode

        def counted_encode(*args, **kwargs):
            self.encode += 1
            return encode(*args, **kwargs)

        def counted_decode(*args, **kwargs):
            self.decode += 1
            return decode(*args, **kwargs)

        monkeypatch.setattr(qsgd, "qsgd_encode", counted_encode)
        monkeypatch.setattr(qsgd, "qsgd_decode", counted_decode)


def _generic_interpreter(monkeypatch) -> None:
    """Run the JAX package's K2/K3 (their kernel bodies and wrappers) under
    Pallas' generic interpreter, which lowers a kernel to XLA operations,
    instead of the TPU interpreter.  The TPU interpreter's callbacks
    dispatch computations of their own, which deadlock when the threaded
    executor's other threads dispatch at the same time; the two
    interpreters give the same bits (checked here on one leaf)."""
    x = jax.numpy.asarray(np.random.RandomState(0).randn(70001).astype(np.float32))
    want = pk.qsgd_encode(x, seed=5, level=255, bits=8)
    want_out = pk.qsgd_decode(*want, level=255, bits=8, n=x.size)
    monkeypatch.setattr(pk, "interpret_param", bool)
    encode = jax.jit(pk.qsgd_encode.__wrapped__, static_argnames=("level", "bits"))
    decode = jax.jit(pk.qsgd_decode.__wrapped__, static_argnames=("level", "bits", "n"))
    got = encode(x, seed=5, level=255, bits=8)
    for a, b in zip((*got, decode(*got, level=255, bits=8, n=x.size)), (*want, want_out)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    monkeypatch.setattr(pk, "qsgd_encode", encode)
    monkeypatch.setattr(pk, "qsgd_decode", decode)


def _obd_task(tmp_path, name, init, workers=2, random=None, **algorithm_kwargs):
    """The port's task; ``random``: the codec's random source, both sides."""
    fields = _obd_fields(tmp_path, name, workers=workers)
    fields["algorithm_kwargs"].update(global_model_path=init, **algorithm_kwargs)
    if random is not None:
        for side in fields["endpoint_kwargs"].values():
            side["random"] = random
    return training.build_task(tconfig.DistributedTrainingConfig(**fields), device="cpu")


def _obd_against_jax(tmp_path, monkeypatch, workers=2, **algorithm_kwargs):
    """The JAX package's run (``use_pallas=True``, its K2/K3 under the
    generic interpreter) and the port's fed the JAX draws, from one init:
    the same phases, round 1 within atol 1e-5 and every record within 5e-3;
    returns the port's task and the K2/K3 calls it made."""
    init = _init_npz(tmp_path / "init.npz", "LongContextTransformer", _obd_fields(tmp_path, "init"), OBD_WIDTH)
    fields = _obd_fields(tmp_path, "jax", workers=workers)
    fields["algorithm_kwargs"].update(global_model_path=init, **algorithm_kwargs)
    monkeypatch.setattr(jqe, "stochastic_quantization", functools.partial(jq.stochastic_quantization, use_pallas=True))
    _generic_interpreter(monkeypatch)
    jres = jax_train(jconfig.DistributedTrainingConfig(**fields))["performance"]

    counted = _Counted(monkeypatch)
    ctx = _obd_task(tmp_path, "torch", init, workers=workers, random=JaxCodecRandom(), **algorithm_kwargs)
    tres = training.run_task(ctx)["performance"]

    phases = [row["phase"] for _, row in sorted(tres.items())]
    assert phases == [row["phase"] for _, row in sorted(jres.items())]
    assert phases == ["block_dropout_rounds"] * ROUNDS + ["epoch_tune"] * 2
    np.testing.assert_allclose(tres[1]["test_loss"], jres[1]["test_loss"], rtol=0, atol=1e-5)
    for key in jres:
        np.testing.assert_allclose(tres[key]["test_loss"], jres[key]["test_loss"], rtol=0, atol=5e-3)
    return ctx, counted


def test_fed_obd_sq_matches_jax_with_the_jax_bits(tmp_path, monkeypatch):
    ctx, counted = _obd_against_jax(tmp_path, monkeypatch)
    # the K2 route: every encode of the embedding, on both wire directions
    assert counted.encode > 0
    assert (counted.encode, counted.decode) == chip_smoke.expected_qsgd_launches(ctx)


def test_fed_obd_sq_with_unselected_workers_matches_jax_under_the_port_stop_rule(tmp_path, monkeypatch):
    """4 workers, 2 selected a round.  The JAX worker stops once its round
    counter passes ``config.round``, so a worker left out of the last
    phase-1 round never takes the switch into phase 2 and the JAX server
    waits for it.  With the port's rule patched into the JAX worker inside
    the test (stop on the counter only in phase 2), the two packages run
    the same protocol and agree within the same bounds."""
    from distributed_learning_simulator_tpu.method.fed_obd import worker as jworker

    def port_stop_rule(self) -> bool:
        if self._last_epoch_announced or self._force_stop:
            return True
        return self._spec.epoch_cadence and super(jworker.FedOBDWorker, self)._stopped()

    monkeypatch.setattr(jworker.FedOBDWorker, "_stopped", port_stop_rule)
    ctx, counted = _obd_against_jax(tmp_path, monkeypatch, workers=4, random_client_number=2)
    assert sum(len(w.block_selector.kept_history) for w in ctx.workers) == ROUNDS * 2
    assert counted.encode > 0
    assert (counted.encode, counted.decode) == chip_smoke.expected_qsgd_launches(ctx)


def test_qsgd_launches_follow_the_protocol_with_unselected_workers(tmp_path, monkeypatch):
    """4 workers, 2 selected a round: the unselected ones wait for the
    switch into phase 2 and join it (every worker uploads in phase 2), and
    the K2/K3 calls are the ones ``chip_smoke.py`` derives."""
    init = _init_npz(tmp_path / "init.npz", "LongContextTransformer", _obd_fields(tmp_path, "init"), OBD_WIDTH)
    counted = _Counted(monkeypatch)
    ctx = _obd_task(tmp_path, "torch", init, workers=4, random_client_number=2)
    perf = training.run_task(ctx)["performance"]
    assert [row["phase"] for _, row in sorted(perf.items())] == ["block_dropout_rounds"] * 2 + ["epoch_tune"] * 2
    assert all(np.isfinite(row["test_loss"]) for row in perf.values())
    assert sum(len(w.block_selector.kept_history) for w in ctx.workers) == ROUNDS * 2
    assert (counted.encode, counted.decode) == chip_smoke.expected_qsgd_launches(ctx)
    ratios = [r for e in [ctx.server._endpoint, *(w._endpoint for w in ctx.workers)] for r in e.compression_ratios]
    assert ratios and all(0.27 < r < 0.30 for r in ratios)  # 9 bits of 32, and padding


def test_a_failing_worker_fails_the_run(tmp_path, monkeypatch):
    """An error on one worker thread sets the abort event: the server and
    the other workers unwind and ``train`` re-raises it."""
    original = Trainer.train

    def train(self):
        if self.name.startswith("worker 1"):
            raise ValueError("planted failure")
        return original(self)

    monkeypatch.setattr(Trainer, "train", train)
    config = tconfig.DistributedTrainingConfig(
        **_avg_fields(tmp_path, "fail", epoch=1, worker_number=3)
    )
    start = time.monotonic()
    with pytest.raises(ValueError, match="planted failure"):
        training.train(config, device="cpu")
    assert time.monotonic() - start < 60


def test_threaded_train_raises_without_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """No fallback: the threaded executor runs on CUDA unless the caller
    names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = tconfig.DistributedTrainingConfig(**_avg_fields(tmp_path, "nocuda"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.train(config)


# ---------------------------------------------------------------- FedOBD units
@pytest.mark.parametrize("early_stop", [False, True])
def test_obd_driver_matches_jax(early_stop):
    """The same decisions for the same aggregate outcomes."""
    drivers = [
        mod.ObdRoundDriver(total_rounds=3, second_phase_epoch=2, early_stop=early_stop)
        for mod in (jdriver, tdriver)
    ]
    outcomes = [(True, False, False), (False, False, False), (True, False, False), (True, False, True),
                (False, False, True), (True, True, True)]
    for improved, ended, check_acc in outcomes:
        got = []
        for d in drivers:
            phase = d.phase.name if d.phase else None
            decision = d.after_aggregate(improved=improved, worker_ended=ended, check_acc=check_acc)
            got.append((phase, decision.annotations, decision.end_training, decision.record_metric, d.finished))
        assert got[0] == got[1]
    names = ["block_dropout_rounds"] * 2 + ["epoch_tune"] * 2
    replays = [
        mod.ObdRoundDriver(total_rounds=3, second_phase_epoch=2, early_stop=early_stop).fast_forward(names)
        for mod in (jdriver, tdriver)
    ]
    assert replays[0] == replays[1]


@pytest.mark.parametrize("rate", [0.3, 0.8])
def test_block_selection_matches_jax(rate):
    """The same kept blocks for the same parameters and cached global."""
    jc = jconfig.DistributedTrainingConfig(
        dataset_name="CIFAR10", dataset_kwargs={"train_size": 8, "val_size": 8, "test_size": 8}
    )
    params = JaxEngine(j_create_model("vit_tiny", j_create_dc(jc)), JaxHP(), total_steps=1).init_params(0)
    rng = np.random.RandomState(int(rate * 10))
    old = {k: np.asarray(v) for k, v in params.items()}
    new = {k: v + rng.randn(*v.shape).astype(np.float32) * rng.uniform(0.01, 1) for k, v in old.items()}

    class Cache:
        def __init__(self, parameter_dict):
            self.parameter_dict = parameter_dict

    jkept = jobd.OpportunisticBlockDropoutAlgorithm(rate, 0).get_block_parameter(
        {k: jax.numpy.asarray(v) for k, v in new.items()}, Cache({k: jax.numpy.asarray(v) for k, v in old.items()})
    )
    selector = tobd.OpportunisticBlockDropoutAlgorithm(rate, 0)
    tkept = selector.get_block_parameter(convert.from_jax(new), Cache(convert.from_jax(old)))
    assert sorted(convert.to_jax(tkept)) == sorted(jkept)
    assert 0 < len(jkept) < len(new)
    assert selector.kept_history == [sorted(tkept)]

