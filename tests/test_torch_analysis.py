"""The port's analysis package (``analysis/``, copies of the JAX package's)
against the JAX functions on the same synthetic artifacts, covering the
cases of ``tests/test_analysis.py`` and ``tests/test_analyze_log_scrape.py``;
both packages' ``Session`` loading a port run's ``save_dir``; and the
port's ``ModuleDiff`` on the port's parameters against the JAX one on the
same parameters through the weight bridge (``models/convert.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import analysis as janalysis
from distributed_learning_simulator_tpu.analysis import analyze_log as jlog
from distributed_learning_simulator_tpu.analysis import analyze_round as jround
from distributed_learning_simulator_tpu.analysis import graph_exp_analyzer as jgraph
from distributed_learning_simulator_tpu.analysis.module_diff import ModuleDiff as JaxModuleDiff
from distributed_learning_simulator_tpu_torch import analysis as tanalysis
from distributed_learning_simulator_tpu_torch.analysis import analyze_log as tlog
from distributed_learning_simulator_tpu_torch.analysis import analyze_round as tround
from distributed_learning_simulator_tpu_torch.analysis import graph_exp_analyzer as tgraph
from distributed_learning_simulator_tpu_torch.analysis.module_diff import ModuleDiff as TorchModuleDiff

PACKAGES = {"jax": (janalysis, jlog, jround, jgraph), "torch": (tanalysis, tlog, tround, tgraph)}


def _fake_session(root):
    """``tests/test_analysis.py``'s session: two record rows, a worker's
    hyperparameters, a graph config and two workers' graph counters."""
    server = root / "run1" / "server"
    server.mkdir(parents=True)
    (server / "round_record.json").write_text(
        json.dumps({"1": {"test_accuracy": 0.5, "test_loss": 1.2}, "2": {"test_accuracy": 0.7, "test_loss": 0.9}})
    )
    (server / "config.json").write_text(
        json.dumps(
            {
                "distributed_algorithm": "fed_gnn",
                "dataset_name": "Coauthor_CS",
                "model_name": "TwoGCN",
                "round": 2,
                "worker_number": 2,
                "algorithm_kwargs": {"share_feature": True},
            }
        )
    )
    worker = root / "run1" / "worker_0"
    worker.mkdir()
    (worker / "hyper_parameter.json").write_text(json.dumps({"epoch": 2}))
    for name, edges in (("worker_0", 10), ("worker_1", 20)):
        (root / "run1" / name).mkdir(exist_ok=True)
        (root / "run1" / name / "graph_worker_stat.json").write_text(
            json.dumps({"embedding_bytes": 100, "in_client_edge_cnt": edges, "round_bytes": {"1": 5, "2": 7}})
        )
    return root / "run1"


def _session_view(session) -> dict:
    return {
        "config": session.config,
        "round_record": session.round_record,
        "worker_dirs": [os.path.basename(d) for d in session.worker_dirs],
        "hyper_parameters": session.hyper_parameters,
        "last_test_acc": session.last_test_acc,
        "mean_test_acc": session.mean_test_acc,
        "shapley_values": session.shapley_values,
    }


def test_sessions_and_round_tables_match_jax(tmp_path):
    path = _fake_session(tmp_path)
    views = {name: _session_view(pkg[0].Session(str(path))) for name, pkg in PACKAGES.items()}
    assert views["torch"] == views["jax"]
    assert views["torch"]["last_test_acc"] == 0.7
    assert tanalysis.GraphSession(str(path)).total_communicated_bytes == janalysis.GraphSession(
        str(path)
    ).total_communicated_bytes
    tables = {name: pkg[2].collect_round_metrics(str(tmp_path)) for name, pkg in PACKAGES.items()}
    assert tables["torch"] == tables["jax"]
    assert tables["torch"]["test_accuracy"][2] == [0.7]


def test_graph_exp_tables_match_jax(tmp_path, monkeypatch):
    path = _fake_session(tmp_path)
    rows = {name: pkg[3].analyze_graph_session(str(path)) for name, pkg in PACKAGES.items()}
    assert rows["torch"] == rows["jax"]
    assert rows["torch"]["in_client_edge_cnt"]["mean"] == 15.0
    written = {}
    for name, pkg in PACKAGES.items():
        out = tmp_path / name
        out.mkdir()
        monkeypatch.chdir(out)
        pkg[3].write_exp_tables([rows[name]])
        with open("exp.json", encoding="utf8") as f:
            written[name] = (sorted(os.listdir(".")), f.read())
    assert written["torch"] == written["jax"]


def test_cost_model_and_scraper_match_jax(tmp_path):
    log = tmp_path / "run.log"
    log.write_text("12:00 INFO send_num 123\n12:01 INFO NNADQ compression ratio: 0.250000\n")
    out = {}
    for name, pkg in PACKAGES.items():
        model = pkg[0].CommunicationCostModel(parameter_count=1000, worker_number=4, rounds=10)
        out[name] = (
            model.fed_avg_bytes(),
            model.fed_avg_bytes(selected_per_round=2),
            model.fed_paq_bytes(quant_bytes=1.0),
            model.fed_obd_bytes(dropout_rate=0.9, compression_ratios=[0.25]),
            model.send_num_bytes([500, 700]),
            pkg[1].scrape_log(str(log)),
        )
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 1000 * 4 * (2 * 10 * 4 + 4)


def _acc_logs(tmp_path) -> dict:
    """The log sets of ``tests/test_analyze_log_scrape.py``, by case."""
    logs = {}
    paths = []
    for i, acc in enumerate((85.3, 87.1, 86.0)):
        p = tmp_path / f"ref{i}.log"
        p.write_text(
            "round: 1, test in dataset accuracy is 50.0%\n"
            f"worker 0 train accuracy: {70 + i}.0%\n"
            f"worker 1 train accuracy: {75 + i}.0%\n"
            f"round: 2, test in dataset accuracy is {acc}%\n"
        )
        paths.append(str(p))
    logs["reference"] = (paths, {"worker_number": 2})
    p = tmp_path / "framework.log"
    p.write_text(
        "round: 1, test accuracy 0.1094 loss 2.2835\n"
        "worker 1 epoch 1 loss 0.5 acc 0.7000 (1.2s)\n"
        "worker 11 epoch 1 loss 0.4 acc 0.9000 (1.2s)\n"
        "round: 2, test accuracy 0.8530 loss 0.4000\n"
    )
    logs["framework"] = ([str(p)], {"worker_number": 12})
    p = tmp_path / "sign.log"
    p.write_text("epoch 3 test loss 0.5 accuracy 91.0%\nnoise\n")
    logs["sign_sgd"] = ([str(p)], {"distributed_algorithm": "sign_SGD"})
    p = tmp_path / "obd.log"
    p.write_text(
        "round: 2, test in dataset accuracy is 60.0%\n"
        "round: 3, test in dataset accuracy is 70.0%\n"
        "round: 2, test in dataset accuracy is 61.0%\n"
    )
    logs["obd_first_stage"] = ([str(p)], {"distributed_algorithm": "fed_obd_first_stage", "rounds": 3})
    return logs


@pytest.mark.parametrize("case", ["reference", "framework", "sign_sgd", "obd_first_stage"])
def test_compute_acc_matches_jax(tmp_path, capsys, case):
    paths, kwargs = _acc_logs(tmp_path)[case]
    results = {}
    for name, pkg in PACKAGES.items():
        results[name] = (pkg[1].compute_acc(paths, **kwargs), capsys.readouterr().out)
    np.testing.assert_equal(results["torch"], results["jax"])  # a single run's std is NaN in both


def _amount_logs(tmp_path) -> dict:
    logs = {"fed_avg": ([], {"distributed_algorithm": "fed_avg", "parameter_count": 1000, "worker_number": 4,
                             "rounds": 3})}
    obd = []
    for i, ratio in enumerate((0.05, 0.07)):
        p = tmp_path / f"obd{i}.log"
        p.write_text(
            f"NNADQClientEndpoint compression ratio: {ratio}\nNNADQServerEndpoint compression ratio: {ratio * 2}\n"
        )
        obd.append(str(p))
    logs["fed_obd"] = (obd, {
        "distributed_algorithm": "fed_obd", "parameter_count": 10_000, "worker_number": 10, "rounds": 5,
        "algorithm_kwargs": {"dropout_rate": 0.3, "second_phase_epoch": 2, "random_client_number": 5},
    })
    p = tmp_path / "send.log"
    p.write_text("worker 0 send_num 500\nworker 1 send_num 700\n")
    logs["send_num"] = ([str(p)], {"distributed_algorithm": "fed_dropout_avg", "parameter_count": 1000,
                                   "worker_number": 2, "rounds": 3})
    return logs


@pytest.mark.parametrize("case", ["fed_avg", "fed_obd", "send_num"])
def test_compute_data_amount_matches_jax(tmp_path, capsys, case):
    paths, kwargs = _amount_logs(tmp_path)[case]
    results = {}
    for name, pkg in PACKAGES.items():
        results[name] = (pkg[1].compute_data_amount(paths, **kwargs), capsys.readouterr().out)
    np.testing.assert_equal(results["torch"], results["jax"])


def test_cli_mains_and_plots_match_jax(tmp_path, capsys):
    """analyze_round / analyze_log as scripts over a session root, and the
    plots (matplotlib is in this image)."""
    session = tmp_path / "algo" / "2026-01-01" / "uuid1"
    os.makedirs(session / "server")
    (session / "server" / "round_record.json").write_text(
        json.dumps({"1": {"test_accuracy": 0.5, "test_loss": 1.2}, "2": {"test_accuracy": 0.75, "test_loss": 0.8}})
    )
    outputs = {}
    for name, pkg in PACKAGES.items():
        pkg[2].main([str(tmp_path / "algo")])
        table = json.loads(capsys.readouterr().out)
        pkg[1].main([str(tmp_path / "algo")])
        summary = json.loads(capsys.readouterr().out)
        written = pkg[2].plot_round_metrics(str(tmp_path / "algo"), str(tmp_path / f"plots_{name}"))
        outputs[name] = (table, summary, sorted(os.path.basename(p) for p in written))
    assert outputs["torch"] == outputs["jax"]
    assert outputs["torch"][1]["final_test_acc_mean"] == 0.75
    assert outputs["torch"][2]


def test_sessions_load_a_port_save_dir(tmp_path):
    """A port run's ``save_dir`` (threaded: the server's record and config,
    the workers' hyperparameters) through both packages' loaders."""
    from distributed_learning_simulator_tpu_torch.config import DistributedTrainingConfig
    from distributed_learning_simulator_tpu_torch.training import train

    config = DistributedTrainingConfig(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm="fed_avg",
        executor="sequential",
        worker_number=2,
        batch_size=32,
        round=2,
        epoch=1,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
        save_dir=str(tmp_path / "port"),
        log_file=str(tmp_path / "port.log"),
    )
    train(config, device="cpu")
    views = {name: _session_view(pkg[0].Session(config.save_dir)) for name, pkg in PACKAGES.items()}
    assert views["torch"] == views["jax"]
    assert sorted(views["torch"]["round_record"]) == [1, 2]
    assert views["torch"]["worker_dirs"] == ["worker_0", "worker_1"]
    assert views["torch"]["config"]["distributed_algorithm"] == "fed_avg"
    found = {name: [s.session_dir for s in pkg[0].session.find_sessions(str(tmp_path))] for name, pkg in PACKAGES.items()}
    assert found["torch"] == found["jax"] == [config.save_dir]


def test_module_diff_matches_jax_on_bridged_params():
    """Two observations of LeNet5-shaped parameters: the port's drifts on
    the port's keys equal the JAX ones on the bridged keys (a block is the
    first path component in both)."""
    from distributed_learning_simulator_tpu_torch.models.convert import to_jax

    gen = torch.Generator().manual_seed(0)
    shapes = {"Conv_0.weight": (6, 1, 5, 5), "Conv_0.bias": (6,), "Dense_0.weight": (10, 84), "Dense_0.bias": (10,)}
    first = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    second = {k: v + 0.1 * torch.randn(v.shape, generator=gen) for k, v in first.items()}
    jdiff, tdiff = JaxModuleDiff(), TorchModuleDiff()
    assert tdiff.observe(first) == jdiff.observe(to_jax(first)) == {}
    got, want = tdiff.observe(second), jdiff.observe(to_jax(second))
    assert sorted(got) == sorted(want) == ["Conv_0", "Dense_0"]
    for block in want:
        np.testing.assert_allclose(got[block], want[block], rtol=1e-6)
    assert tdiff.observe(second) == {"Conv_0": 0.0, "Dense_0": 0.0}
