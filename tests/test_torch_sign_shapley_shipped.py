"""The 11 shipped files that the sign-SGD and Shapley-value sessions bring
onto the port: ``conf/sign_sgd/{cifar10,cifar100,imdb}.yaml``,
``conf/gtg_sv/{cifar10,cifar100,imdb,mnist}.yaml``,
``conf/hierarchical_sv/{cifar10,mnist}.yaml`` and
``conf/multiround_sv/{cifar10,cifar100}.yaml``.  Each goes through the
port's ``load_config`` at full model width, with only the round, the local
epochs, the batch and the dataset sizes cut (one training sample a worker,
two test samples), for one round on the CPU: the record's loss finite, the
Shapley files' per-round SV dicts over every worker and their two JSON
files written."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.training import train as torch_train

#: the files this slice runs on the port, as shipped
SHIPPED = [
    "sign_sgd/cifar10.yaml",
    "sign_sgd/cifar100.yaml",
    "sign_sgd/imdb.yaml",
    "gtg_sv/cifar10.yaml",
    "gtg_sv/cifar100.yaml",
    "gtg_sv/imdb.yaml",
    "gtg_sv/mnist.yaml",
    "hierarchical_sv/cifar10.yaml",
    "hierarchical_sv/mnist.yaml",
    "multiround_sv/cifar10.yaml",
    "multiround_sv/cifar100.yaml",
]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_runs_one_round(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)  # session/ and log/ land here
    shipped = tconfig.load_config(["--config-name", name])
    sizes = {"train_size": shipped.worker_number, "val_size": 4, "test_size": 2}
    overrides = ["++round=1", "++epoch=1", "++batch_size=1"]
    overrides += [f"++dataset_kwargs.{k}={v}" for k, v in sizes.items()]
    config = tconfig.load_config(["--config-name", name, *overrides])
    cut = {"round", "epoch", "batch_size", "dataset_kwargs", "save_dir", "log_file"}
    for field in dataclasses.fields(config):
        if field.name not in cut:
            assert getattr(config, field.name) == getattr(shipped, field.name), field.name
    assert config.dataset_kwargs == {**shipped.dataset_kwargs, **sizes}
    # one intra-op thread: full-width models at batch 1 gain little from
    # more, and the test workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = torch_train(config, device="cpu")
    finally:
        torch.set_num_threads(threads)
    perf = result["performance"]
    assert sorted(perf) == [1]
    row = perf[1]
    assert np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0
    assert row["test_count"] == 2.0
    if config.distributed_algorithm == "sign_SGD":
        assert len(row["train_loss_per_epoch"]) == 1 and np.isfinite(row["train_loss_per_epoch"][0])
        assert os.path.isfile(os.path.join(config.save_dir, "server", "best_global_model.npz"))
        return
    assert row["subsets"] > 0
    assert sorted(result["sv"]) == [1] and sorted(result["sv"][1]) == list(range(config.worker_number))
    assert set(result["sv_S"][1]) <= set(range(config.worker_number))
    for record in ("shapley_values.json", "shapley_values_S.json"):
        with open(os.path.join(config.save_dir, record), encoding="utf8") as f:
            assert sorted(json.load(f)) == ["1"]
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        assert sorted(json.load(f)) == ["0", "1"]
