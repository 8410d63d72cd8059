"""The 16 shipped files that ``round_horizon`` / ``remat_policy`` and the
sparse sessions bring onto the port: ``conf/large_scale/fed_obd/{cifar10,
cifar100,cifar100_sq,imdb}.yaml`` (100 workers, 50 selected,
``round_horizon`` 5, ``remat_policy: dots_saveable``), and the FedDropoutAvg
and SMAFD files (``conf/{fed_dropout_avg,smafd}/*`` and their
``large_scale`` twins).  Each goes through the port's ``load_config`` at
full model width, with only the round, the local epochs, the tuning
epochs, the batch and the dataset sizes cut (one training sample a
worker), for one round (and one tuning epoch) on the CPU: every record's
loss finite and the record count right."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.training import train as torch_train

#: the files this slice runs on the port, as shipped
SHIPPED = [
    "large_scale/fed_obd/cifar10.yaml",
    "large_scale/fed_obd/cifar100.yaml",
    "large_scale/fed_obd/cifar100_sq.yaml",
    "large_scale/fed_obd/imdb.yaml",
    "fed_dropout_avg/cifar10.yaml",
    "fed_dropout_avg/cifar100.yaml",
    "fed_dropout_avg/imdb.yaml",
    "large_scale/fed_dropout_avg/cifar10.yaml",
    "large_scale/fed_dropout_avg/cifar100.yaml",
    "large_scale/fed_dropout_avg/imdb.yaml",
    "smafd/cifar10.yaml",
    "smafd/cifar100.yaml",
    "smafd/imdb.yaml",
    "large_scale/smafd/cifar10.yaml",
    "large_scale/smafd/cifar100.yaml",
    "large_scale/smafd/imdb.yaml",
]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_runs_one_round(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)  # session/ and log/ land here
    shipped = tconfig.load_config(["--config-name", name])
    obd = shipped.distributed_algorithm in ("fed_obd", "fed_obd_sq")
    if obd:
        assert int(shipped.algorithm_kwargs["round_horizon"]) == 5
        assert shipped.extra_hyper_parameters == {"remat_policy": "dots_saveable"}
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
        assert 0.0 < row["received_mb"] < row["sent_mb"] or obd
