"""The 8 shipped graph files that the graph sessions bring onto the port:
``conf/fed_gnn/{cs,yelp,amazonproduct}.yaml``, ``conf/fed_gcn/cs.yaml`` and
``conf/fed_aas/{cora,PubMed,dblp,reddit}.yaml``.  Each goes through the
port's ``load_config`` at full model width for one round on the CPU, with
only the round, the local epochs and the graph's size cut (256 nodes, 16
features; ``CitationFull`` has a fixed size, so ``dblp.yaml`` runs 10 of
its 100 workers instead): the record's loss finite, the exchange priced
where features are shared, and both npz artifacts written.  The ninth
file, ``conf/fed_aas/yelp.yaml``, names ``Yelp``, which neither package
registers: it raises the JAX package's ``KeyError``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.training import train as torch_train

#: the files this slice runs on the port, as shipped
SHIPPED = [
    "fed_gnn/cs.yaml",
    "fed_gnn/yelp.yaml",
    "fed_gnn/amazonproduct.yaml",
    "fed_gcn/cs.yaml",
    "fed_aas/cora.yaml",
    "fed_aas/PubMed.yaml",
    "fed_aas/dblp.yaml",
    "fed_aas/reddit.yaml",
]
SIZES = {"num_nodes_": 256, "num_features_": 16}
#: CitationFull's size is fixed: dblp.yaml's [100, 40,960, 64] messages
#: would take a gigabyte a gather here
DBLP_WORKERS = 10


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_runs_one_round(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)  # session/ and log/ land here
    shipped = tconfig.load_config(["--config-name", name])
    overrides = ["++round=1", "++epoch=1"]
    cut = {"round", "epoch", "dataset_kwargs", "save_dir", "log_file"}
    if shipped.dataset_name == "CitationFull":
        overrides.append(f"++worker_number={DBLP_WORKERS}")
        cut.add("worker_number")
        sizes = {}
    else:
        sizes = SIZES
        overrides += [f"++dataset_kwargs.{k}={v}" for k, v in sizes.items()]
    config = tconfig.load_config(["--config-name", name, *overrides])
    for field in dataclasses.fields(config):
        if field.name not in cut:
            assert getattr(config, field.name) == getattr(shipped, field.name), field.name
    assert config.dataset_kwargs == {**shipped.dataset_kwargs, **sizes}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        perf = torch_train(config, device="cpu")["performance"]
    finally:
        torch.set_num_threads(threads)
    assert sorted(perf) == [1]
    row = perf[1]
    assert np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0
    assert row["test_count"] > 0
    shares = config.distributed_algorithm in ("fed_gnn", "fed_gcn")
    assert (row["received_mb"] > 0) == shares and row["sent_mb"] == row["received_mb"]
    assert os.path.isfile(os.path.join(config.save_dir, "aggregated_model", "round_1.npz"))
    if row["test_accuracy"] > 0:
        assert os.path.isfile(os.path.join(config.save_dir, "server", "best_global_model.npz"))


def test_fed_aas_yelp_raises_the_jax_key_error(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config = tconfig.load_config(["--config-name", "fed_aas/yelp.yaml"])
    with pytest.raises(KeyError, match="unknown dataset 'Yelp'"):
        torch_train(config, device="cpu")
