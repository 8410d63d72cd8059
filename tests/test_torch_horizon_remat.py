"""``round_horizon`` and ``remat_policy`` on the port's SPMD sessions.

* ``round_horizon`` 5 against 1 on the port, bit for bit (every record's
  metrics and wire MB, the final npz), with a tail horizon (7 rounds: 5 +
  2), for fed_avg, fed_paq, fed_obd and fed_obd_sq (3 tuning epochs after
  the switch, so both phases end on a horizon boundary), on LeNet5/MNIST.
* ``early_stop`` with a horizon runs per round, warns, and gives the
  H = 1 run.
* ``conf/large_scale/fed_obd/imdb.yaml`` (100 workers, 50 selected, the
  classifier at full width with ``remat_policy: dots_saveable``) on the
  port at its own ``round_horizon`` 5 against the JAX package at H = 1
  (the reference's horizon parity is broken, ROADMAP R1), sizes cut:
  every record at rtol 1e-4 and the final npz with level flips counted
  (``test_torch_fed_obd.py``'s check).  With the classifier's dropout 0
  in both packages: flax's dropout bits cannot be reproduced (R5).
* A remat step (bare ``remat``, ``nothing_saveable``, ``dots_saveable``)
  equals the plain step bit for bit, several steps in a row, on the
  classifier with its dropout at 0.1 drawing from an explicit generator
  (checkpointing does not restore a generator passed in), on DenseNet-40
  (both checkpointed block by block) and on LeNet5's convolutions (one
  region around the loss); the classifier's backward recomputes its
  blocks one at a time; a whole remat round equals the plain round.
* The refusals: an unknown ``remat_policy`` raises ``ValueError`` (the
  port's vocabulary is ``jax.checkpoint_policies``'), a JAX policy the
  port does not implement ``NotImplementedError``, and FedDropoutAvg and
  SMAFD with ``round_horizon`` > 1 the JAX session's ``ValueError``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.parallel import spmd_sparse as jspmd_sparse
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.engine import engine as tengine
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.models.dropout import dropout_generator

import chip_smoke
from test_torch_fed_obd import _no_text_dropout

WORKERS = 4
#: how near a rounding boundary, in level steps, a client's upload of an
#: element must sit for the two packages' last-bit differences to flip it
BOUNDARY = 0.001

#: the IMDB classifier at d_model 32, 2 heads, 2 layers over 16 tokens
TEXT = dict(
    dataset_name="imdb",
    model_name="TransformerClassificationModel",
    dataset_kwargs={"max_len": 16, "vocab_size": 200, "train_size": 64, "val_size": 16, "test_size": 32},
    model_kwargs={"max_len": 16, "d_model": 32, "nhead": 2, "num_encoder_layer": 2},
)

#: DenseNet-40 over a few CIFAR-10 samples: its dense and transition
#: layers are its remat blocks
DENSENET = dict(
    dataset_name="CIFAR10",
    model_name="densenet40",
    dataset_kwargs={"train_size": 32, "val_size": 8, "test_size": 8},
)


def _fields(tmp_path, name, algorithm, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm=algorithm,
        worker_number=WORKERS,
        batch_size=8,
        round=7,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
        save_dir=str(tmp_path / name),
    )
    fields.update(extra)
    return fields


def _run(tmp_path, name, algorithm, **extra):
    return _run_config(tconfig.DistributedTrainingConfig(**_fields(tmp_path, name, algorithm, **extra)))


def _run_config(config):
    perf = training.train(config, device="cpu")["performance"]
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        records = json.load(f)
    last = max(perf)
    with np.load(os.path.join(config.save_dir, "aggregated_model", f"round_{last}.npz")) as blob:
        final = {k: blob[k] for k in blob.files}
    return perf, records, final


def _without_time(rows: dict) -> dict:
    return {k: {f: v for f, v in row.items() if f != "round_seconds"} for k, row in rows.items()}


def _assert_bit_equal(a, b) -> None:
    (perf_a, rec_a, final_a), (perf_b, rec_b, final_b) = a, b
    assert _without_time(perf_a) == _without_time(perf_b)
    assert _without_time(rec_a) == _without_time(rec_b)
    assert sorted(final_a) == sorted(final_b)
    for key in final_a:
        assert final_a[key].tobytes() == final_b[key].tobytes(), key



@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The port's small ops on one intra-op thread: the test workers share
    the machine's cores, and many threads over tiny tensors mostly wait
    on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.mark.parametrize(
    "algorithm,kwargs",
    [
        ("fed_avg", {"random_client_number": 2}),
        ("fed_paq", {"random_client_number": 2}),
        ("fed_obd", {"second_phase_epoch": 3, "dropout_rate": 0.5, "random_client_number": 2}),
        ("fed_obd_sq", {"second_phase_epoch": 3, "dropout_rate": 0.5, "random_client_number": 2}),
    ],
    ids=["fed_avg", "fed_paq", "fed_obd", "fed_obd_sq"],
)
def test_horizon_is_bit_equal_to_per_round(tmp_path, algorithm, kwargs):
    per_round = _run(tmp_path, "h1", algorithm, algorithm_kwargs=kwargs)
    fused = _run(tmp_path, "h5", algorithm, algorithm_kwargs={**kwargs, "round_horizon": 5})
    _assert_bit_equal(per_round, fused)
    phases = [row.get("phase") for _, row in sorted(per_round[0].items())]
    obd = algorithm.startswith("fed_obd")
    assert phases == (["block_dropout_rounds"] * 7 + ["epoch_tune"] * 3 if obd else [None] * 7)


def test_early_stop_with_a_horizon_runs_per_round_and_warns(tmp_path):
    kwargs = {"second_phase_epoch": 2, "dropout_rate": 0.5, "early_stop": True}
    per_round = _run(tmp_path, "h1", "fed_obd", round=3, algorithm_kwargs=kwargs)
    log = tmp_path / "h5.log"
    fused = _run(tmp_path, "h5", "fed_obd", round=3, algorithm_kwargs={**kwargs, "round_horizon": 5}, log_file=str(log))
    warned = [line for line in log.read_text().splitlines() if "WARNING" in line and "early_stop" in line]
    assert len(warned) == 1 and "running per-round (H=1)" in warned[0]
    _assert_bit_equal(per_round, fused)


def test_large_scale_imdb_at_its_horizon_matches_jax_per_round(tmp_path, monkeypatch):
    """``conf/large_scale/fed_obd/imdb.yaml`` as shipped (100 workers, 50
    selected, ``round_horizon`` 5, ``remat_policy: dots_saveable``, the
    classifier at full width) but for sizes: 5 rounds and 1 tuning epoch
    of one epoch at batch 2 over 2 samples a worker, so the port runs a
    horizon of 5, then one of 1 after the switch; the JAX package runs the
    same file at ``round_horizon`` 1.

    * The port's ``train()`` at the file's H = 5 writes a record for each
      of the 5 rounds and the tuning epoch, and its first row is the first
      aggregate below bit for bit (both train from the init); H = 5
      against H = 1 over whole runs, bit for bit, is
      ``test_horizon_is_bit_equal_to_per_round``'s.
    * The port against JAX aggregate by aggregate: the port's session
      trains each aggregate from its codec's broadcast of JAX's previous
      exact average (the codec is bit-equal), and its exact average must
      match JAX's within 1e-4 · |value| + 1e-5 but for elements upload
      level flips apart (at most 0.1%, ``chip_smoke.flipped_elements``:
      one flip's move, or several clients' moves together: the last
      LayerNorm bias's delta has one direction for every client, so
      clients' uploads of an element sit on a level boundary together),
      and its test loss JAX's row at rtol 1e-4 once those elements take
      JAX's values; the broadcast's bits equal, the uploads' at rtol 1e-5
      (where a client's leaf sits on NNADQ's width decision its width can
      flip: 96 of 88.6 M bits in one tuning epoch).  Over a whole run at
      this learning rate (0.05, two samples a client) a flip's move of the
      next broadcast grows: run against run, the rows part by 2.5e-3 by
      the third round."""
    _no_text_dropout(monkeypatch)
    monkeypatch.chdir(tmp_path)
    name = "large_scale/fed_obd/imdb.yaml"
    overrides = ["++round=5", "++batch_size=2", "++algorithm_kwargs.second_phase_epoch=1",
                 "++dataset_kwargs.train_size=200", "++dataset_kwargs.val_size=8", "++dataset_kwargs.test_size=16"]
    shipped = jconfig.load_config(["--config-name", name, *overrides])
    assert shipped.worker_number == 100 and shipped.algorithm_kwargs["random_client_number"] == 50
    assert shipped.algorithm_kwargs["round_horizon"] == 5
    assert shipped.extra_hyper_parameters == {"remat_policy": "dots_saveable"}
    ctx = j_create_model(shipped.model_name, j_create_dc(shipped), **shipped.model_kwargs)
    init = str(tmp_path / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()})
    overrides.append(f"++algorithm_kwargs.global_model_path={init}")
    jc = jconfig.load_config(["--config-name", name, *overrides, "++algorithm_kwargs.round_horizon=1",
                              f"++save_dir={tmp_path / 'jax'}"])
    jres = jax_train(jc)["performance"]

    def port_config(label: str, *more: str):
        config = tconfig.load_config(["--config-name", name, *overrides, *more, f"++save_dir={tmp_path / label}"])
        assert config.model_kwargs["max_len"] == 300 and config.model_kwargs["d_model"] == 100
        return config

    fused = training.train(port_config("h5"), device="cpu")["performance"]
    assert [fused[k]["phase"] for k in sorted(fused)] == ["block_dropout_rounds"] * 5 + ["epoch_tune"]

    session = training.build_session(port_config("lockstep"), device="cpu")
    layout = session.engine.layout
    g = session._init_global_params()
    flipped, near, loss_rel, widths = [], [], [], []
    for key in sorted(jres):
        phase_two = jres[key]["phase"] == "epoch_tune"
        weights = session._all_weights() if phase_two else session._base_weight_row(key)
        with chip_smoke.CodecSteps(boundary=BOUNDARY) as steps:
            exact, _, upload_bits, bcast_bits = session.run_aggregate(g, weights, key, phase_two)
        with np.load(os.path.join(jc.save_dir, "aggregated_model", f"round_{key}.npz")) as blob:
            want = {k: blob[k] for k in blob.files}
        got = convert.to_jax(layout.split(exact))
        counts = []
        masks = chip_smoke.flipped_elements(got, want, steps, key - 1, atol=1e-5, rtol=1e-4, match=1e-3,
                                            within_tolerance=True, counts=counts)
        near.append(max(counts, default=0))
        flipped.append(sum(int(m.sum()) for m in masks.values()))
        assert flipped[-1] <= 1e-3 * layout.size, (key, flipped[-1])
        settled = layout.flatten(convert.from_jax({k: np.where(masks[k], want[k], got[k]) for k in got}))
        loss = session._evaluate(settled)["loss"]
        if key == 1:
            first = session._evaluate(exact)
            assert (first["loss"], first["accuracy"]) == (fused[1]["test_loss"], fused[1]["test_accuracy"])
            assert float(upload_bits) / 8e6 == fused[1]["received_mb"]
        loss_rel.append(abs(loss - jres[key]["test_loss"]) / jres[key]["test_loss"])
        np.testing.assert_allclose(loss, jres[key]["test_loss"], rtol=1e-4, err_msg=str(key))
        # the same bit widths but where a client's leaf sits on NNADQ's
        # width decision (a flip of its own: a bit a value of that leaf)
        moved = round(float(upload_bits)) - round(jres[key]["received_mb"] * 8e6)
        widths.append(moved)
        np.testing.assert_allclose(float(upload_bits) / 8e6, jres[key]["received_mb"], rtol=1e-5)
        np.testing.assert_allclose(float(bcast_bits) / 8e6, jres[key]["sent_mb"], rtol=1e-6)
        # the next aggregate trains from the codec's broadcast of JAX's exact average
        g, _ = session._broadcast(layout.flatten(convert.from_jax(want)), key - 1)
    print(f"{name}: elements level flips apart by aggregate {flipped} (at most {near} clients near a"
          f" boundary on one); test loss rel {loss_rel}; upload bits moved by a width decision {widths}")


# ---------------------------------------------------------------- remat
def _session(tmp_path, name, extra, **fields):
    config = tconfig.DistributedTrainingConfig(
        **{**_fields(tmp_path, name, "fed_avg", round=1, **fields), "extra_hyper_parameters": extra}
    )
    return training.build_session(config, device="cpu")


def _steps(session, n: int = 4):
    """``n`` SGD steps of client 0 from the init, dropout drawing from one
    generator; returns the parameters, the momentum trace and the
    generator's state."""
    engine = session.engine
    params = session._init_global_params()
    state = engine.init_opt_state(params)
    generator = dropout_generator(0, 1, 0, "cpu")
    data = {k: v[0] for k, v in session._data.items()}
    for i in range(n):
        batch = {k: v[i % v.shape[0]] for k, v in data.items()}
        engine.train_step(params, state, batch, float(session._counts[0][i % len(session._counts[0])]), generator)
    return params, state.trace, generator.get_state()


@pytest.mark.parametrize(
    "extra", [{"remat": True}, {"remat_policy": "nothing_saveable"}, {"remat_policy": "dots_saveable"}],
    ids=["remat", "nothing_saveable", "dots_saveable"],
)
@pytest.mark.parametrize("family", ["text_classifier", "lenet5", "densenet40"])
def test_remat_step_equals_the_plain_step_bit_for_bit(tmp_path, family, extra):
    fields = {"text_classifier": TEXT, "lenet5": {}, "densenet40": DENSENET}[family]
    plain = _session(tmp_path, "plain", {}, **fields)
    remat = _session(tmp_path, "remat", extra, **fields)
    assert plain.engine.remat is None and remat.engine.remat == ("dots" if "dots" in str(extra) else "nothing")
    if family == "text_classifier":
        rates = {m.rate for m in plain.model_ctx.module.modules() if type(m).__name__ == "Dropout"}
        assert rates == {0.1}
    got, want = _steps(remat), _steps(plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_remat_recomputes_the_classifier_block_by_block(tmp_path):
    """Under remat each ``EncoderLayer`` is a checkpointed region of its
    own: the backward recomputes one block at a time, the last first (one
    region around the whole loss would recompute both at once, in forward
    order, and hold all of it)."""
    session = _session(tmp_path, "blocks", {"remat_policy": "dots_saveable"}, **TEXT)
    module = session.model_ctx.module
    assert module.remat_blocks == ("EncoderLayer_0", "EncoderLayer_1")
    calls = []
    for name in module.remat_blocks:
        attention = module.get_submodule(name).FusedSelfAttention_0
        attention.register_forward_hook(lambda *_, name=name: calls.append(name))
    _steps(session, 1)
    assert calls == ["EncoderLayer_0", "EncoderLayer_1", "EncoderLayer_1", "EncoderLayer_0"]
    assert not any("forward" in vars(module.get_submodule(name)) for name in module.remat_blocks)


def test_a_remat_round_equals_the_plain_round(tmp_path):
    """A whole FedAvg round of the classifier (dropout 0.1, 2 epochs with
    the best-epoch validation) under ``dots_saveable``."""
    rounds = []
    for name, extra in (("plain", {}), ("remat", {"remat_policy": "dots_saveable"})):
        session = _session(tmp_path, name, extra, **{**TEXT, "epoch": 2})
        g = session._init_global_params()
        rounds.append(session.run_round(g, session._base_weight_row(1), 1))
    assert torch.equal(rounds[0], rounds[1])


def test_threaded_remat_equals_the_plain_run(tmp_path):
    """The threaded executor's workers share one module: under remat each
    step holds it from the forward to the end of the backward's
    recomputes (which bind the module's blocks again), so the run is the
    plain run's, the classifier's dropout drawing from each worker's
    generator.  The executor sums uploads as they arrive, so two plain
    runs differ in the last bits (up to 2.4e-7 apart); a recompute bound
    to another worker's parameters would move them by a learning-rate
    step."""
    runs = []
    for name, extra in (("plain", {}), ("remat", {"remat_policy": "dots_saveable"})):
        config = tconfig.DistributedTrainingConfig(
            **{**_fields(tmp_path, name, "fed_avg", round=2, executor="sequential", **TEXT),
               "extra_hyper_parameters": extra}
        )
        runs.append(_run_config(config))
    (perf, _, final), (want_perf, _, want_final) = runs
    for key in want_perf:
        np.testing.assert_allclose(perf[key]["test_loss"], want_perf[key]["test_loss"], rtol=1e-5)
    for key in want_final:
        np.testing.assert_allclose(final[key], want_final[key], rtol=0, atol=1e-5, err_msg=key)


def test_remat_policy_vocabulary_is_jax_checkpoint_policies():
    policies = jax.checkpoint_policies
    names = sorted(p for p in dir(policies) if not p.startswith("_") and callable(getattr(policies, p)))
    assert list(tengine.JAX_CHECKPOINT_POLICIES) == names
    assert set(tengine.PORTED_POLICIES) <= set(names)
    assert tengine.resolve_remat({}) is None and tengine.resolve_remat({"remat": False}) is None
    assert tengine.resolve_remat({"remat_policy": "everything_saveable"}) is None
    assert tengine.resolve_remat({"remat_policy": "checkpoint_dots", "remat": False}) == "dots"


def test_an_unknown_remat_policy_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown remat_policy 'dots_savable'.*dots_saveable"):
        _session(tmp_path, "unknown", {"remat_policy": "dots_savable"})
    with pytest.raises(NotImplementedError, match="offload_dot_with_no_batch_dims"):
        _session(tmp_path, "unported", {"remat_policy": "offload_dot_with_no_batch_dims"})
    with pytest.raises(NotImplementedError, match="donate_buffers"):
        _session(tmp_path, "donate", {"donate_buffers": True})


@pytest.mark.parametrize(
    "algorithm,cls",
    [("fed_dropout_avg", jspmd_sparse.SpmdFedDropoutAvgSession), ("single_model_afd", jspmd_sparse.SpmdSMAFDSession)],
    ids=["fed_dropout_avg", "single_model_afd"],
)
def test_sparse_sessions_refuse_a_horizon_as_jax_does(tmp_path, algorithm, cls):
    config = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "refused", algorithm, algorithm_kwargs={"dropout_rate": 0.3, "round_horizon": 2})
    )
    with pytest.raises(ValueError) as raised:
        training.train(config, device="cpu")
    assert str(raised.value) == cls._horizon_unsupported_reason()
