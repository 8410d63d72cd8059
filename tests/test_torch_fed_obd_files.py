"""Shipped files held against the JAX package's output on the same file:
``conf/fed_obd/imdb.yaml`` and ``conf/fed_paq/imdb.yaml`` through both
packages' ``load_config``, unmodified but for sizes (rounds, epochs,
batch, dataset sizes; the model at full width, max_len 300), from one
JAX init, the classifier's ``EncoderLayer`` dropout set to 0 in both
packages inside the test and the port's QSGD fed the JAX session's own
draws.  Every record's test loss at rtol 1e-4, accuracy, phase and wire
MB, and the final npz (``test_torch_fed_obd.py``'s checks)."""

import numpy as np
import pytest

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training

import chip_smoke
from test_torch_fed_obd import JaxSessionRandom, _assert_trajectories_match, _no_text_dropout

#: (file, rounds, tuning epochs)
FILES = [("fed_obd/imdb.yaml", 2, 1), ("fed_paq/imdb.yaml", 2, 0)]


@pytest.mark.parametrize("name,rounds,tuning", FILES)
def test_shipped_file_matches_jax(tmp_path, monkeypatch, name, rounds, tuning):
    _no_text_dropout(monkeypatch)
    monkeypatch.chdir(tmp_path)  # session/ and log/ land here
    overrides = [f"++round={rounds}", "++epoch=1", "++batch_size=4", "++dataset_kwargs.train_size=40",
                 "++dataset_kwargs.val_size=8", "++dataset_kwargs.test_size=16"]
    if tuning:
        overrides.append(f"++algorithm_kwargs.second_phase_epoch={tuning}")
    shipped = jconfig.load_config(["--config-name", name, *overrides])
    ctx = j_create_model(shipped.model_name, j_create_dc(shipped), **shipped.model_kwargs)
    init = str(tmp_path / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()})
    overrides.append(f"++algorithm_kwargs.global_model_path={init}")
    jc = jconfig.load_config(["--config-name", name, *overrides, f"++save_dir={tmp_path / 'jax'}"])
    tc = tconfig.load_config(["--config-name", name, *overrides, f"++save_dir={tmp_path / 'torch'}"])
    assert tc.model_kwargs["max_len"] == 300 and tc.model_kwargs["d_model"] == 100
    mode = "paq" if tc.distributed_algorithm == "fed_paq" else "obd"
    tc.endpoint_kwargs.setdefault("worker", {})["random"] = JaxSessionRandom(mode, jc.seed, jc.worker_number)
    jres = jax_train(jc)["performance"]
    with chip_smoke.CodecSteps() as steps:
        tres = training.train(tc, device="cpu")["performance"]
    phases = ["block_dropout_rounds"] * rounds + ["epoch_tune"] * tuning if tuning else [None] * rounds
    stepped = _assert_trajectories_match(jc, tc, jres, tres, steps, phases)
    # fed_obd: 187 of the classifier's 2,242,802, one flip each
    print(f"{name}: {stepped} elements a level flip apart")
