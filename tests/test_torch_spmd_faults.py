"""The fault plan on the SPMD sessions other than FedAvg, the port against
the JAX package on the same configs from one JAX init (LeNet5/MNIST):

* FedOBD and FedOBD-SQ (``parallel/spmd_obd.py``): dropout, and
  corruption under the update guard, in phase 1 (with and without a
  selection) and in phase 2; the records' ``rejected_updates`` equal, the
  trajectories held as ``tests/test_torch_fed_obd.py`` holds them (its
  tolerances and level-flip rule; FedOBD-SQ fed the JAX session's QSGD
  draws);
* sign_SGD (``parallel/spmd_sign_sgd.py``): dropout and a corrupt voter
  under the vote guard, from the JAX init; the runs within
  ``tests/test_torch_sign_sgd.py``'s whole-run bounds and
  ``rejected_updates`` (summed over the round's steps) equal;
* FedDropoutAvg and SMAFD (``parallel/spmd_sparse.py``): dropout,
  stragglers and the quorum (their JAX sessions refuse the guard), the
  JAX session's keep masks and leaf orders injected, held as
  ``tests/test_torch_sparse.py`` holds them; a corrupt client without the
  guard poisons the aggregate in both;
* GTG (``parallel/spmd_shapley.py``): dropout into the subset metrics'
  weights; the SV dicts equal and the records' test loss at rtol 1e-5;
* a quorum lost on each session raises the JAX package's
  ``QuorumLostError``;
* the accept/raise table over session × knob: where the JAX session
  raises, the port raises the same ``ValueError``; where it builds, the
  port builds, but for the knobs the JAX session takes and ignores, which
  the port refuses naming ROADMAP R18 (the fault plan on the graph
  sessions, ``client_faults_nonfatal`` on every SPMD session).
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu import training as jtraining
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu.util import faults as jfaults
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.util import faults as tfaults

import test_torch_fed_obd as obd_tests
import test_torch_shapley as shapley_tests
import test_torch_sign_sgd as sign_tests
import test_torch_sparse as sparse_tests


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


def _rejected(config) -> list:
    return [row.get("rejected_updates") for _, row in sorted(_records(config).items(), key=lambda kv: int(kv[0]))]


# ------------------------------------------------------------ FedOBD, FedOBD-SQ
#: phase 1 is rounds 1-2, phase 2 the aggregates keyed 3-4
OBD_PLANS = {
    "dropout_both_phases": {"dropout_schedule": {1: [0], 3: [2]}},
    "guard_corrupt_both_phases": {"corrupt_schedule": {2: [1], 4: [3]}, "dropout_schedule": {3: [0]},
                                  "update_guard": True},
}


@pytest.mark.parametrize("selected", [None, 2], ids=["all", "two_selected"])
@pytest.mark.parametrize("plan", sorted(OBD_PLANS))
@pytest.mark.parametrize("algorithm", ["fed_obd", "fed_obd_sq"])
def test_fed_obd_fault_trajectory_matches_jax(tmp_path, algorithm, plan, selected):
    jc, tc, jres, tres, steps = obd_tests._run_both(
        tmp_path, algorithm, selected, fault_tolerance=dict(OBD_PLANS[plan])
    )
    obd_tests._assert_trajectories_match(jc, tc, jres, tres, steps, obd_tests.OBD_PHASES)
    assert _rejected(tc) == _rejected(jc)
    if "update_guard" in OBD_PLANS[plan]:
        # the corrupt client of round 2 counts where round 2 selected it; phase 2's always
        assert _rejected(tc)[3] == 1


# ------------------------------------------------------------ sign_SGD
def test_sign_sgd_fault_run_matches_jax(tmp_path):
    plan = {"dropout_schedule": {1: [0, 5]}, "corrupt_schedule": {2: [3]}, "update_guard": True}
    jc, tc = sign_tests._configs(tmp_path, sign_tests.LENET, fault_tolerance=plan)
    ref = sign_tests.JaxSign(jc)
    session = sign_tests._port_session(tc, ref.init())
    tres = session.run()["performance"]
    jres = jax_train(jc)["performance"]
    sign_tests._assert_runs_close(jc, tc, jres, tres)
    assert [tres[r]["rejected_updates"] for r in (1, 2)] == [jres[r]["rejected_updates"] for r in (1, 2)]
    assert tres[2]["rejected_updates"] > 0 == tres[1]["rejected_updates"]


# ------------------------------------------------------------ FedDropoutAvg, SMAFD
SPARSE_PLANS = {
    "dropout_stragglers": ({"dropout_schedule": {1: [0], 2: [1, 2]}, "straggler_schedule": {2: [3]},
                            "straggler_delay_seconds": 0.0}, {"min_client_quorum": 1}),
    "corrupt_without_guard": ({"corrupt_schedule": {2: [1]}}, {}),
}


@pytest.mark.parametrize("plan", sorted(SPARSE_PLANS))
@pytest.mark.parametrize("algorithm", ["fed_dropout_avg", "single_model_afd"])
def test_sparse_fault_trajectory_matches_jax(tmp_path, algorithm, plan):
    faults, extra_kwargs = SPARSE_PLANS[plan]
    kwargs = {"dropout_rate": 0.3, **extra_kwargs}
    jc, tc, jres, tres = sparse_tests._run_both(tmp_path, algorithm, kwargs, fault_tolerance=dict(faults))
    if plan == "corrupt_without_guard":
        # round 2's NaN weight poisons the aggregate visibly in both; which
        # elements it reaches differs (the JAX program's XLA rewrites
        # FedDropoutAvg's ``(x != 0) * w`` into a select, so an element the
        # client dropped stays finite there; the port's K1 multiplies every
        # element by the weight)
        assert np.isnan(tres[2]["test_loss"]) and np.isnan(jres[2]["test_loss"])
        np.testing.assert_allclose(tres[1]["test_loss"], jres[1]["test_loss"], rtol=1e-4)
        for final in (sparse_tests._final(jc), sparse_tests._final(tc)):
            assert any(np.isnan(v).any() for v in final.values())
        return
    sparse_tests._assert_match(jc, tc, jres, tres)


# ------------------------------------------------------------ GTG
def test_gtg_dropout_matches_jax(tmp_path, monkeypatch):
    fields = shapley_tests._fields
    monkeypatch.setattr(
        shapley_tests, "_fields",
        lambda *a, **kw: fields(*a, **kw, fault_tolerance={"dropout_schedule": {1: [0], 2: [1, 2]}}),
    )
    jc, tc, jres, capture, tres, session, stacks = shapley_tests._run_session(
        tmp_path, monkeypatch, "GTG_shapley_value", 3, {}
    )
    assert tres["sv"] == jres["sv"] and tres["sv_S"] == jres["sv_S"]
    for r, want in jres["performance"].items():
        got = tres["performance"][r]
        np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-5)
        assert got["test_accuracy"] == want["test_accuracy"]
    assert sorted(tres["sv"]) == [1, 2] and all(len(sv) == 3 for sv in tres["sv"].values())


# ------------------------------------------------------------ quorum
def _small(tmp_path, name, algorithm, **extra):
    fields = dict(
        dataset_name="MNIST", model_name="LeNet5", distributed_algorithm=algorithm, worker_number=3, batch_size=8,
        round=2, epoch=1, learning_rate=0.05, dataset_kwargs={"train_size": 24, "val_size": 8, "test_size": 16},
        save_dir=str(tmp_path / name), log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


#: the algorithm_kwargs each session needs to build
NEEDS = {
    "fed_avg": {},
    "fed_obd": {"second_phase_epoch": 1, "dropout_rate": 0.5},
    "fed_obd_sq": {"second_phase_epoch": 1, "dropout_rate": 0.5},
    "fed_dropout_avg": {"dropout_rate": 0.3},
    "single_model_afd": {"dropout_rate": 0.3},
    "sign_SGD": {},
    "GTG_shapley_value": {},
}


@pytest.mark.parametrize("algorithm", sorted(NEEDS))
def test_quorum_loss_raises_as_jax(tmp_path, algorithm):
    extra = dict(fault_tolerance={"dropout_schedule": {2: [0, 1]}},
                 algorithm_kwargs={**NEEDS[algorithm], "min_client_quorum": 2})
    jc = jconfig.DistributedTrainingConfig(**_small(tmp_path, "jax", algorithm, **extra))
    tc = tconfig.DistributedTrainingConfig(**_small(tmp_path, "torch", algorithm, **extra))
    with pytest.raises(jfaults.QuorumLostError, match="min_client_quorum=2") as want:
        jax_train(jc)
    with pytest.raises(tfaults.QuorumLostError) as got:
        training.train(tc, device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ accept/raise table
KNOBS = {
    "update_guard": dict(fault_tolerance={"update_guard": True}),
    "dropout": dict(fault_tolerance={"dropout_rate": 0.2}),
    "quorum": dict(algorithm_kwargs={"min_client_quorum": 1}),
    "buffered": dict(algorithm_kwargs={"aggregation_mode": "buffered"}),
    "nonfatal": dict(fault_tolerance={"client_faults_nonfatal": True}),
    "kill": dict(fault_tolerance={"kill_after_rounds": [1]}),
}
TABLE_SESSIONS = {**NEEDS, "fed_gnn": {}}


def _build(package, config):
    if package == "jax":
        task = jtraining._build_task(config)
        return jtraining._make_spmd_session(task)
    return training.build_session(config, device="cpu")


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("algorithm", sorted(TABLE_SESSIONS))
def test_session_takes_or_refuses_each_knob_as_jax(tmp_path, algorithm, knob):
    extra = {k: dict(v) for k, v in KNOBS[knob].items()}
    extra["algorithm_kwargs"] = {**TABLE_SESSIONS[algorithm], **extra.get("algorithm_kwargs", {})}
    if algorithm == "fed_gnn":
        extra.update(dataset_name="Coauthor_CS", model_name="TwoGCN", dataset_kwargs={"num_nodes_": 64})
    jc = jconfig.DistributedTrainingConfig(**_small(tmp_path, "jax", algorithm, **extra))
    tc = tconfig.DistributedTrainingConfig(**_small(tmp_path, "torch", algorithm, **extra))
    try:
        _build("jax", jc)
        want = None
    except ValueError as exc:
        want = str(exc)
    ignored = knob == "nonfatal" or (algorithm == "fed_gnn" and knob != "kill")
    if want is not None:
        with pytest.raises(ValueError) as got:
            _build("torch", tc)
        assert str(got.value) == want
    elif ignored:
        with pytest.raises(NotImplementedError, match="R18"):
            _build("torch", tc)
    else:
        _build("torch", tc)
