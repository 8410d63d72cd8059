"""The shipped fed_obd, fed_obd_sq and fed_paq files on the port's SPMD
sessions: each through the port's ``load_config`` at full model width,
with only the round, the local epochs, the tuning epochs, the batch and
the dataset sizes cut (one training sample a worker), for one round (and
one tuning epoch) on the CPU."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.training import train as torch_train

#: the shipped files of the FedOBD family and fed_paq that run on the port
SHIPPED = [
    "fed_obd/cifar10.yaml",
    "fed_obd/cifar100.yaml",
    "fed_obd/imdb.yaml",
    "fed_obd/vit_cifar100.yaml",
    "fed_obd_sq/cifar100.yaml",
    "fed_obd_sq/vit_cifar100.yaml",
    "fed_paq/cifar10.yaml",
    "fed_paq/cifar100.yaml",
    "fed_paq/imdb.yaml",
    "large_scale/fed_paq/cifar10.yaml",
    "large_scale/fed_paq/cifar100.yaml",
    "large_scale/fed_paq/imdb.yaml",
]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_runs_one_round(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)  # session/ and log/ land here
    shipped = tconfig.load_config(["--config-name", name])
    obd = shipped.distributed_algorithm in ("fed_obd", "fed_obd_sq")
    sizes = {"train_size": shipped.worker_number, "val_size": 4, "test_size": 4}
    overrides = ["++round=1", "++epoch=1", "++batch_size=1"]
    overrides += [f"++dataset_kwargs.{k}={v}" for k, v in sizes.items()]
    if obd:
        overrides.append("++algorithm_kwargs.second_phase_epoch=1")
    config = tconfig.load_config(["--config-name", name, *overrides])
    cut = {"round", "epoch", "batch_size", "dataset_kwargs", "algorithm_kwargs", "save_dir", "log_file"}
    for field in dataclasses.fields(config):
        if field.name not in cut:
            assert getattr(config, field.name) == getattr(shipped, field.name), field.name
    assert config.dataset_kwargs == {**shipped.dataset_kwargs, **sizes}
    assert config.algorithm_kwargs == {**shipped.algorithm_kwargs, **({"second_phase_epoch": 1} if obd else {})}
    # one intra-op thread: full-width models at batch 1 gain little from
    # more, and the test workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        perf = torch_train(config, device="cpu")["performance"]
    finally:
        torch.set_num_threads(threads)
    # every round and FedOBD's optimizer states are checkpointed (up to 4 GB
    # at vit_base's 10 slots): free the disk now, not at the session's end
    shutil.rmtree(config.save_dir)
    phases = [row.get("phase") for _, row in sorted(perf.items())]
    assert phases == (["block_dropout_rounds", "epoch_tune"] if obd else [None])
    for row in perf.values():
        assert np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0
        assert row["test_count"] == 4.0
        assert 0.0 < row["received_mb"] and 0.0 < row["sent_mb"]
