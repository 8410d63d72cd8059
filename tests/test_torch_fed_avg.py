"""End to end: the JAX package's ``train(config)`` against the port's
``train(config, device="cpu")`` on the same FedAvg task.

Both start from one npz of JAX parameters (``algorithm_kwargs.
global_model_path``, written from the JAX engine's ``init_params``), see
byte-equal data and partitions, and run the SPMD session (``vit_tiny``,
2 workers, tiny ``train_size``).  The JAX side runs on the CPU test mesh.
"""

import dataclasses
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
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.training import train as torch_train

ROUNDS = 2


def _fields(tmp_path, name, **extra):
    fields = dict(
        dataset_name="CIFAR10",
        model_name="vit_tiny",
        distributed_algorithm="fed_avg",
        worker_number=2,
        batch_size=16,
        round=ROUNDS,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


def _write_init(path, fields) -> str:
    """The JAX engine's init params for the task ``fields`` describe, as an npz."""
    config = jconfig.DistributedTrainingConfig(**fields)
    ctx = j_create_model(config.model_name, j_create_dc(config), **config.model_kwargs)
    params = JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return str(path)


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """The JAX engine's init params for the task, as an npz."""
    path = tmp_path_factory.mktemp("init") / "init.npz"
    return _write_init(path, _fields(path.parent, "init"))


def _run_both(tmp_path, init_npz, **extra):
    kwargs = {"global_model_path": init_npz, **extra.pop("algorithm_kwargs", {})}
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", algorithm_kwargs=kwargs, **extra))
    tc = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "torch", algorithm_kwargs=kwargs, **extra))
    jc.load_config_and_process()
    tc.load_config_and_process()
    jres = jax_train(jc)["performance"]
    tres = torch_train(tc, device="cpu")["performance"]
    return jc, tc, jres, tres


def _assert_trajectories_match(jc, tc, jres, tres, test_count):
    assert sorted(tres) == sorted(jres) == list(range(1, ROUNDS + 1))
    for r in jres:
        # f32 SGD over 2 rounds: the packages sum in other orders, which
        # moves the test loss in its 5th-6th digit
        np.testing.assert_allclose(tres[r]["test_loss"], jres[r]["test_loss"], rtol=1e-4)
        assert tres[r]["test_accuracy"] == jres[r]["test_accuracy"]
        assert tres[r]["test_count"] == jres[r]["test_count"] == test_count
    jparams, tparams = _final_params(jc), _final_params(tc)
    assert sorted(tparams) == sorted(jparams)
    for key, value in jparams.items():
        np.testing.assert_allclose(tparams[key], value, rtol=1e-4, atol=1e-5, err_msg=key)
    with open(os.path.join(jc.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        jrecord = json.load(f)
    with open(os.path.join(tc.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        trecord = json.load(f)
    assert sorted(trecord) == sorted(jrecord)
    for r in jrecord:
        assert sorted(trecord[r]) == sorted(jrecord[r])


def _final_params(config):
    path = os.path.join(config.save_dir, "aggregated_model", f"round_{config.round}.npz")
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def test_fed_avg_f32_matches_jax(tmp_path, init_npz):
    jc, tc, jres, tres = _run_both(tmp_path, init_npz)
    _assert_trajectories_match(jc, tc, jres, tres, 32.0)


#: tiny tasks of the shipped model families: LeNet5 on MNIST with 2 local
#: epochs (the iid best-epoch validation policy), and the IMDB classifier
#: at d_model 32, 2 heads, 2 layers over 16 tokens
FAMILIES = {
    "lenet5": dict(dataset_name="MNIST", model_name="LeNet5", epoch=2, batch_size=8),
    "text_classifier": dict(
        dataset_name="imdb",
        model_name="TransformerClassificationModel",
        dataset_kwargs={"max_len": 16, "vocab_size": 200, "train_size": 64, "val_size": 16, "test_size": 32},
        model_kwargs={"max_len": 16, "d_model": 32, "nhead": 2, "num_encoder_layer": 2},
    ),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_family_trajectory_matches_jax(tmp_path, monkeypatch, family):
    """2 FedAvg rounds of each family from one init, JAX SPMD session
    against the port on the CPU.  The classifier's dropout (0.1, the JAX
    layer's default; flax's threefry bits cannot be reproduced) is set to
    0 in both packages for this test only."""
    if family == "text_classifier":
        from distributed_learning_simulator_tpu.models import text as jtext
        from distributed_learning_simulator_tpu_torch.models import text as ttext

        # flax names a submodule by its class: the subclass keeps the name
        class EncoderLayer(jtext.EncoderLayer):
            dropout_rate: float = 0.0

        class TorchEncoderLayer(ttext.EncoderLayer):
            def __init__(self, *args, dropout_rate: float = 0.0, **kwargs):
                super().__init__(*args, dropout_rate=dropout_rate, **kwargs)

        monkeypatch.setattr(jtext, "EncoderLayer", EncoderLayer)
        monkeypatch.setattr(ttext, "EncoderLayer", TorchEncoderLayer)
    task = FAMILIES[family]
    init = _write_init(tmp_path / "init.npz", _fields(tmp_path, "init", **task))
    jc, tc, jres, tres = _run_both(tmp_path, init, **task)
    _assert_trajectories_match(jc, tc, jres, tres, 32.0)


def test_fed_avg_amp_tracks_jax(tmp_path, init_npz):
    """``use_amp``: bf16 params, trace and activations in both; the loss
    may drift by bf16 rounding but stays with JAX's."""
    _, _, jres, tres = _run_both(tmp_path, init_npz, use_amp=True, round=1)
    # ~3 significant digits per bf16 op over a 2-layer model and 2 steps
    np.testing.assert_allclose(tres[1]["test_loss"], jres[1]["test_loss"], rtol=5e-2)


def test_client_chunking_does_not_change_the_round(tmp_path, init_npz):
    """K1 per chunk of 1 or of 2 clients: the same f32 sum up to rounding."""
    results = []
    for chunk in (1, 2):
        config = tconfig.DistributedTrainingConfig(
            **_fields(
                tmp_path,
                f"chunk{chunk}",
                worker_number=4,
                round=1,
                algorithm_kwargs={"global_model_path": init_npz, "client_chunk": chunk},
            )
        )
        torch_train(config, device="cpu")
        results.append(_final_params(config))
    for key in results[0]:
        np.testing.assert_allclose(results[0][key], results[1][key], rtol=1e-6, atol=1e-7)


def test_unported_paths_raise(tmp_path, monkeypatch):
    base = _fields(tmp_path, "refused")
    obd = {"second_phase_epoch": 1, "dropout_rate": 0.5}
    for change in (
        # the Shapley values run threaded; resume on the threaded roles does not
        {"distributed_algorithm": "GTG_shapley_value", "executor": "sequential",
         "algorithm_kwargs": {"resume_dir": "earlier"}},
        {"distributed_algorithm": "fed_obd", "algorithm_kwargs": {**obd, "round_horizon": 2, "population_store": "streamed"}},
        {"executor": "sequential", "algorithm_kwargs": {"aggregation_mode": "buffered"}},
        {"executor": "sequential", "algorithm_kwargs": {"float64_parity": True}},
        {"algorithm_kwargs": {"round_horizon": 2, "selection_gather": True}},
        {"algorithm_kwargs": {"population_store": "streamed"}},
        {"extra_hyper_parameters": {"donate_buffers": True}},
        {"extra_hyper_parameters": {"remat_policy": "save_only_these_names"}},
        # the kill runs on the SPMD sessions (tests/test_torch_recovery.py), not on the threaded executor
        {"executor": "sequential", "fault_tolerance": {"kill_after_rounds": [1]}},
        {
            "model_name": "TransformerClassificationModel",
            "dataset_name": "imdb",
            "model_kwargs": {"pipeline_stages": 1},
        },
    ):
        config = tconfig.DistributedTrainingConfig(**{**base, **change})
        with pytest.raises(NotImplementedError):
            torch_train(config, device="cpu")
    # the shipped FedOBD files that fuse rounds (round_horizon: 5) on more
    # than one device (the other four run: tests/test_torch_sparse_shipped.py)
    monkeypatch.chdir(tmp_path)
    for name in ("longcontext_imdb_sp", "moe_imdb_ep"):
        config = tconfig.load_config(["--config-name", f"large_scale/fed_obd/{name}.yaml"])
        assert int(config.algorithm_kwargs["round_horizon"]) == 5
        with pytest.raises(NotImplementedError):
            torch_train(config, device="cpu")


#: the shipped files that run on the port as they are
SHIPPED = [
    "fed_avg/cifar10.yaml",
    "fed_avg/cifar100.yaml",
    "fed_avg/imagenet.yaml",
    "fed_avg/mnist.yaml",
    "fed_avg/imdb.yaml",
    "large_scale/fed_avg/cifar10.yaml",
    "large_scale/fed_avg/cifar100.yaml",
    "large_scale/fed_avg/imdb.yaml",
    "fed_avg/mnist_buffered.yaml",
]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_runs_one_round(tmp_path, monkeypatch, name):
    """Each file through the port's ``load_config`` at full model width,
    with only the round, the local epochs, the batch and the dataset sizes
    cut (one training sample a worker), for one round on the CPU."""
    monkeypatch.chdir(tmp_path)  # session/ and log/ land here
    shipped = tconfig.load_config(["--config-name", name])
    sizes = {"train_size": shipped.worker_number, "val_size": 4, "test_size": 4}
    overrides = ["++round=1", "++epoch=1", "++batch_size=1"]
    overrides += [f"++dataset_kwargs.{k}={v}" for k, v in sizes.items()]
    config = tconfig.load_config(["--config-name", name, *overrides])
    cut = {"round", "epoch", "batch_size", "dataset_kwargs", "save_dir", "log_file"}
    for field in dataclasses.fields(config):
        if field.name not in cut:
            assert getattr(config, field.name) == getattr(shipped, field.name), field.name
    assert config.dataset_kwargs == {**shipped.dataset_kwargs, **sizes}
    # one intra-op thread: full-width convolutions at batch 1 gain little
    # from more, and the test workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        row = torch_train(config, device="cpu")["performance"][1]
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0
    assert row["test_count"] == 4.0


def test_train_keeps_f32_products_in_f32(tmp_path, monkeypatch, init_npz):
    """``train()`` switches TF32 off for f32 convolutions and matrix
    products (``utils/device.py``), whatever the process set before."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    config = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "precision", round=1, algorithm_kwargs={"global_model_path": init_npz})
    )
    torch_train(config, device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
