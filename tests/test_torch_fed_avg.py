"""End to end: the JAX package's ``train(config)`` against the port's
``train(config, device="cpu")`` on the same FedAvg task.

Both start from one npz of JAX parameters (``algorithm_kwargs.
global_model_path``, written from the JAX engine's ``init_params``), see
byte-equal data and partitions, and run the SPMD session (``vit_tiny``,
2 workers, tiny ``train_size``).  The JAX side runs on the CPU test mesh.
"""

import json
import os

import jax
import numpy as np
import pytest

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


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """The JAX engine's init params for the task, as an npz."""
    path = tmp_path_factory.mktemp("init") / "init.npz"
    config = jconfig.DistributedTrainingConfig(**_fields(path.parent, "init"))
    ctx = j_create_model("vit_tiny", j_create_dc(config))
    params = JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return str(path)


def _run_both(tmp_path, init_npz, **extra):
    kwargs = {"global_model_path": init_npz, **extra.pop("algorithm_kwargs", {})}
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", algorithm_kwargs=kwargs, **extra))
    tc = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "torch", algorithm_kwargs=kwargs, **extra))
    jc.load_config_and_process()
    tc.load_config_and_process()
    jres = jax_train(jc)["performance"]
    tres = torch_train(tc, device="cpu")["performance"]
    return jc, tc, jres, tres


def _final_params(config):
    path = os.path.join(config.save_dir, "aggregated_model", f"round_{config.round}.npz")
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def test_fed_avg_f32_matches_jax(tmp_path, init_npz):
    jc, tc, jres, tres = _run_both(tmp_path, init_npz)
    assert sorted(tres) == sorted(jres) == list(range(1, ROUNDS + 1))
    for r in jres:
        # f32 SGD over 2 rounds x 2 steps: the packages sum in other orders,
        # which moves the test loss in its 5th-6th digit
        np.testing.assert_allclose(tres[r]["test_loss"], jres[r]["test_loss"], rtol=1e-4)
        assert tres[r]["test_accuracy"] == jres[r]["test_accuracy"]
        assert tres[r]["test_count"] == jres[r]["test_count"] == 32.0
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


def test_unported_paths_raise(tmp_path):
    base = _fields(tmp_path, "refused")
    obd = {"second_phase_epoch": 1, "dropout_rate": 0.5}
    for change in (
        {"distributed_algorithm": "fed_paq"},
        {"distributed_algorithm": "fed_paq", "executor": "sequential"},
        {"distributed_algorithm": "fed_obd", "executor": "sequential", "algorithm_kwargs": obd},
        {"distributed_algorithm": "fed_obd_sq", "executor": "sequential", "algorithm_kwargs": obd},
        {"executor": "sequential", "algorithm_kwargs": {"aggregation_mode": "buffered"}},
        {"executor": "sequential", "algorithm_kwargs": {"float64_parity": True}},
        {"algorithm_kwargs": {"round_horizon": 2}},
        {"algorithm_kwargs": {"population_store": "streamed"}},
        {"model_name": "densenet40"},
    ):
        config = tconfig.DistributedTrainingConfig(**{**base, **change})
        with pytest.raises(NotImplementedError):
            torch_train(config, device="cpu")
