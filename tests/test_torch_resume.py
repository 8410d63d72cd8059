"""Round checkpoints and resume on the port's SPMD sessions, on the CPU.

* In the port: a run killed after round k (``kill_after_rounds``) and
  resumed from its ``save_dir`` gives the uninterrupted run's record rows
  (the times apart) and final parameters, bit for bit, on every session
  that checkpoints: fed_avg, fed_paq, buffered fed_avg, FedOBD and
  fed_obd_sq (resumed in phase 1, at the switch and in phase 2),
  FedDropoutAvg and SMAFD; Shapley and fed_gnn, which arm no kill, resume
  a shorter run's ``save_dir``.
* Across packages: the port resumes a FedAvg ``save_dir`` the JAX package
  wrote and the JAX package one the port wrote, and the resumed rounds
  match the other package's uninterrupted rounds at the FedAvg parity
  tests' tolerance (``tests/test_torch_fed_avg.py``).  Resuming a
  JAX-written FedOBD ``save_dir``, the port stays on the JAX package's
  uninterrupted trajectory and the JAX session leaves it (reference
  caveat R15 in ``ROADMAP.md``).
* ``opt_state.npz`` and ``err_state.npz`` carry the JAX package's keys,
  shapes and dtypes.
"""

import json
import os
import shutil

import numpy as np
import pytest

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.training import train
from distributed_learning_simulator_tpu_torch.util.buffered import BufferedSettings, compute_arrival_schedule
from distributed_learning_simulator_tpu_torch.util.faults import FaultPlan, SimulatedPreemption

#: record keys that hold wall times
TIMES = ("round_seconds", "subset_seconds")
OBD = {"dropout_rate": 0.3, "second_phase_epoch": 2, "early_stop": False}


def _fields(tmp_path, name, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm="fed_avg",
        worker_number=3,
        batch_size=8,
        round=4,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 48, "val_size": 8, "test_size": 16},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


def _config(tmp_path, name, **extra) -> tconfig.DistributedTrainingConfig:
    return tconfig.DistributedTrainingConfig(**_fields(tmp_path, name, **extra))


def _rows(performance: dict) -> dict:
    return {r: {k: v for k, v in row.items() if k not in TIMES} for r, row in performance.items()}


def _npz(path) -> dict:
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def _assert_params_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _last_round(save_dir) -> int:
    names = os.listdir(os.path.join(save_dir, "aggregated_model"))
    return max(int(n[len("round_") : -len(".npz")]) for n in names if n.startswith("round_"))


def _assert_resume_is_uninterrupted(straight, resumed, straight_dir, resumed_dir) -> None:
    assert _rows(resumed) == _rows(straight)
    last = _last_round(straight_dir)
    assert _last_round(resumed_dir) == last
    _assert_params_equal(
        _npz(os.path.join(resumed_dir, "aggregated_model", f"round_{last}.npz")),
        _npz(os.path.join(straight_dir, "aggregated_model", f"round_{last}.npz")),
    )


KILLED = {
    "fed_avg": (2, {}),
    "fed_paq": (2, {"distributed_algorithm": "fed_paq"}),
    # worker 0's round-1 upload lands at flush 2: nothing is in flight at the resume
    "buffered": (2, {"algorithm_kwargs": {"aggregation_mode": "buffered"},
                     "fault_tolerance": {"straggler_schedule": {1: [0]}}}),
    "fed_dropout_avg": (2, {"distributed_algorithm": "fed_dropout_avg", "algorithm_kwargs": {"dropout_rate": 0.3}}),
    # at 0.1 LeNet5's largest leaf (78% of the parameters) is sent in some
    # uploads and not in others, so the residuals carried over the resume count
    "smafd": (2, {"distributed_algorithm": "single_model_afd", "algorithm_kwargs": {"dropout_rate": 0.1}}),
    # 3 rounds of block dropout (2 of 4 clients a round: slots 1 and 2, 0 and
    # 3, then 1 and 2, so slots 0 and 3 enter phase 2 with their round-2
    # optimizer states, saved with every round), then 2 tuning epochs
    "fed_obd_phase1": (2, {"distributed_algorithm": "fed_obd", "round": 3, "worker_number": 4,
                           "algorithm_kwargs": {**OBD, "random_client_number": 2}}),
    "fed_obd_switch": (3, {"distributed_algorithm": "fed_obd", "round": 3, "algorithm_kwargs": OBD}),
    "fed_obd_phase2": (4, {"distributed_algorithm": "fed_obd", "round": 3, "algorithm_kwargs": OBD}),
    "fed_obd_sq": (2, {"distributed_algorithm": "fed_obd_sq", "round": 3, "algorithm_kwargs": OBD}),
}


@pytest.mark.parametrize("case", sorted(KILLED))
def test_killed_and_resumed_run_is_the_uninterrupted_run(tmp_path, case):
    kill, extra = KILLED[case]
    extra = dict(extra)
    faults = extra.pop("fault_tolerance", {})
    straight_config = _config(tmp_path, "straight", fault_tolerance=faults, **extra)
    straight = train(straight_config, device="cpu")["performance"]
    killed = _config(tmp_path, "killed", fault_tolerance={**faults, "kill_after_rounds": [kill]}, **extra)
    with pytest.raises(SimulatedPreemption):
        train(killed, device="cpu")
    with open(os.path.join(killed.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        assert sorted(int(k) for k in json.load(f)) == list(range(1, kill + 1))
    kwargs = {**extra.pop("algorithm_kwargs", {}), "resume_dir": killed.save_dir}
    resumed_config = _config(tmp_path, "resumed", fault_tolerance=faults, algorithm_kwargs=kwargs, **extra)
    resumed = train(resumed_config, device="cpu")["performance"]
    _assert_resume_is_uninterrupted(straight, resumed, straight_config.save_dir, resumed_config.save_dir)
    if case == "smafd":
        state = _npz(os.path.join(killed.save_dir, "aggregated_model", "err_state.npz"))
        assert int(state["__round__"]) == kill
    opt_state = os.path.join(killed.save_dir, "aggregated_model", "opt_state.npz")
    if case == "fed_obd_sq":  # full participation: phase 1 saves no optimizer state before the switch
        assert not os.path.exists(opt_state)
    elif case.startswith("fed_obd"):
        assert int(_npz(opt_state)["stat_key"]) == kill
    assert os.path.isfile(os.path.join(straight_config.save_dir, "server", "best_global_model.npz"))


@pytest.mark.parametrize(
    "algorithm, extra",
    [
        ("GTG_shapley_value", {"worker_number": 3, "dataset_kwargs": {"train_size": 24, "val_size": 8, "test_size": 32}}),
        ("fed_gnn", {"dataset_name": "Coauthor_CS", "model_name": "TwoGCN", "worker_number": 3,
                     "dataset_kwargs": {"num_nodes_": 256, "num_features_": 16},
                     "algorithm_kwargs": {"share_feature": True, "edge_drop_rate": 0.5, "batch_number": 2,
                                          "num_neighbor": 3}}),
    ],
    ids=["shapley", "fed_gnn"],
)
def test_resume_of_a_shorter_run_is_the_uninterrupted_run(tmp_path, algorithm, extra):
    """The Shapley and graph sessions arm no kill (as in JAX): a 2-round
    run's ``save_dir`` resumed for round 3 is the 3-round run."""
    extra = dict(extra)
    kwargs = extra.pop("algorithm_kwargs", {})
    straight_config = _config(tmp_path, "straight", distributed_algorithm=algorithm, round=3,
                              algorithm_kwargs=kwargs, **extra)
    straight = train(straight_config, device="cpu")
    first = _config(tmp_path, "first", distributed_algorithm=algorithm, round=2, algorithm_kwargs=kwargs, **extra)
    first_result = train(first, device="cpu")
    resumed_config = _config(tmp_path, "resumed", distributed_algorithm=algorithm, round=3,
                             algorithm_kwargs={**kwargs, "resume_dir": first.save_dir}, **extra)
    resumed = train(resumed_config, device="cpu")
    _assert_resume_is_uninterrupted(
        straight["performance"], resumed["performance"], straight_config.save_dir, resumed_config.save_dir
    )
    if algorithm == "GTG_shapley_value":
        # rounds 1-2 brought forward, both key levels int; round 3 computed afresh
        for key in ("sv", "sv_S"):
            assert sorted(resumed[key]) == [1, 2, 3]
            for r in (1, 2):
                assert resumed[key][r] == first_result[key][r]
        with open(os.path.join(resumed_config.save_dir, "shapley_values.json"), encoding="utf8") as f:
            assert sorted(json.load(f)) == ["1", "2", "3"]


def test_buffered_resume_drains_the_buffer(tmp_path):
    """Worker 0's round-2 upload lands at flush 3; a resume after round 2
    loses it (the pending ring restarts at zeros), and flush 3's counts
    leave it out, as the schedule's ``live_cohort`` above the floor says."""
    faults = {"straggler_schedule": {2: [0]}}
    kwargs = {"aggregation_mode": "buffered"}
    straight = train(_config(tmp_path, "straight", algorithm_kwargs=kwargs, fault_tolerance=faults), device="cpu")
    killed = _config(tmp_path, "killed", algorithm_kwargs=kwargs, fault_tolerance={**faults, "kill_after_rounds": [2]})
    with pytest.raises(SimulatedPreemption):
        train(killed, device="cpu")
    resumed_config = _config(
        tmp_path, "resumed", algorithm_kwargs={**kwargs, "resume_dir": killed.save_dir}, fault_tolerance=faults
    )
    resumed = train(resumed_config, device="cpu")["performance"]
    straight = straight["performance"]
    schedule = compute_arrival_schedule(BufferedSettings(), FaultPlan.from_config(resumed_config), 3, 4, lambda r: (0, 1, 2))
    assert (0, 2) in [(item.worker, item.origin) for item in schedule.cohort(3)]
    assert _rows(resumed)[1] == _rows(straight)[1] and _rows(resumed)[2] == _rows(straight)[2]
    assert straight[2]["buffer_depth"] == 1 and resumed[2]["buffer_depth"] == 1  # restored rows
    assert straight[3]["flush_cohort"] == len(schedule.cohort(3)) and straight[3]["stale_updates"] == 1
    assert resumed[3]["flush_cohort"] == len(schedule.live_cohort(3, 3)) == len(schedule.cohort(3)) - 1
    assert resumed[3]["stale_updates"] == 0
    assert resumed[3]["test_loss"] != straight[3]["test_loss"]  # the lost update
    assert np.isfinite(resumed[4]["test_loss"])


# ---------------------------------------------------------------- across packages
CROSS = dict(worker_number=4, round=4, epoch=1, batch_size=8,
             dataset_kwargs={"train_size": 64, "val_size": 8, "test_size": 32})


@pytest.fixture(scope="module")
def cross_runs(tmp_path_factory):
    """Both packages' uninterrupted 4-round FedAvg runs from one JAX init."""
    tmp = tmp_path_factory.mktemp("cross")
    config = jconfig.DistributedTrainingConfig(**_fields(tmp, "init", **CROSS))
    ctx = j_create_model(config.model_name, j_create_dc(config))
    init = JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0)
    init_path = str(tmp / "init.npz")
    np.savez(init_path, **{k: np.asarray(v) for k, v in init.items()})
    kwargs = {"global_model_path": init_path}
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp, "jax", algorithm_kwargs=kwargs, **CROSS))
    tc = _config(tmp, "torch", algorithm_kwargs=kwargs, **CROSS)
    return tmp, init_path, jax_train(jc)["performance"], jc.save_dir, train(tc, device="cpu")["performance"], tc.save_dir


def _cut_after(save_dir: str, target: str, last: int) -> str:
    """The ``save_dir`` a run killed after round ``last`` leaves: its
    checkpoints up to ``last`` and its record rows up to ``last``."""
    os.makedirs(os.path.join(target, "aggregated_model"))
    os.makedirs(os.path.join(target, "server"))
    for r in range(1, last + 1):
        name = f"round_{r}.npz"
        shutil.copyfile(os.path.join(save_dir, "aggregated_model", name), os.path.join(target, "aggregated_model", name))
    with open(os.path.join(save_dir, "server", "round_record.json"), encoding="utf8") as f:
        record = {k: v for k, v in json.load(f).items() if int(k) <= last}
    with open(os.path.join(target, "server", "round_record.json"), "w", encoding="utf8") as f:
        json.dump(record, f)
    return target


def _assert_rounds_match(got: dict, want: dict, got_dir: str, want_dir: str) -> None:
    """The FedAvg parity tolerance: f32 SGD summed in other orders."""
    for r in (3, 4):
        np.testing.assert_allclose(got[r]["test_loss"], want[r]["test_loss"], rtol=1e-4)
        assert got[r]["test_accuracy"] == want[r]["test_accuracy"]
    a, b = _npz(os.path.join(got_dir, "aggregated_model", "round_4.npz")), _npz(
        os.path.join(want_dir, "aggregated_model", "round_4.npz")
    )
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-4, atol=1e-5, err_msg=key)


def test_port_resumes_a_jax_save_dir(cross_runs):
    tmp, init_path, jres, jdir, _, _ = cross_runs
    resume_dir = _cut_after(jdir, str(tmp / "jax_cut"), 2)
    tc = _config(tmp, "torch_resumed", algorithm_kwargs={"global_model_path": init_path, "resume_dir": resume_dir},
                 **CROSS)
    got = train(tc, device="cpu")["performance"]
    assert sorted(got) == [1, 2, 3, 4]
    assert got[1] == jres[1] and got[2] == jres[2]  # restored verbatim
    _assert_rounds_match(got, jres, tc.save_dir, jdir)


def test_jax_resumes_a_port_save_dir(cross_runs):
    tmp, init_path, _, _, tres, tdir = cross_runs
    resume_dir = _cut_after(tdir, str(tmp / "torch_cut"), 2)
    jc = jconfig.DistributedTrainingConfig(
        **_fields(tmp, "jax_resumed", algorithm_kwargs={"global_model_path": init_path, "resume_dir": resume_dir},
                  **CROSS)
    )
    got = jax_train(jc)["performance"]
    assert sorted(got) == [1, 2, 3, 4]
    _assert_rounds_match(got, tres, jc.save_dir, tdir)


#: fed_obd as ``tests/test_torch_fed_obd.py`` runs it against JAX: 2 rounds
#: of block dropout, all 4 clients, then 2 tuning epochs
OBD_CROSS = dict(CROSS, distributed_algorithm="fed_obd", round=2, epoch=2, dataset_kwargs={
    "train_size": 64, "val_size": 16, "test_size": 32})
OBD_CROSS_KWARGS = {"second_phase_epoch": 2, "dropout_rate": 0.5}


def test_fed_obd_resume_of_a_jax_save_dir_follows_r15(tmp_path):
    """Reference caveat R15: resuming one JAX-written FedOBD ``save_dir``
    (cut after aggregate 1), the JAX session trains aggregate 2 from the
    restored exact average, and so leaves its own uninterrupted
    trajectory; the port codes the average again and trains from the
    broadcast the uninterrupted run sent, so it stays on the JAX
    uninterrupted trajectory at the FedOBD parity tests' tolerance."""
    init_config = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "init", **OBD_CROSS))
    ctx = j_create_model(init_config.model_name, j_create_dc(init_config))
    init_path = str(tmp_path / "init.npz")
    init = JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0)
    np.savez(init_path, **{k: np.asarray(v) for k, v in init.items()})
    kwargs = {**OBD_CROSS_KWARGS, "global_model_path": init_path}

    def jax_run(name, **more):
        jc = jconfig.DistributedTrainingConfig(
            **_fields(tmp_path, name, algorithm_kwargs={**kwargs, **more}, **OBD_CROSS))
        return jax_train(jc)["performance"], jc.save_dir

    straight, straight_dir = jax_run("jax")
    assert [straight[r]["phase"] for r in sorted(straight)] == ["block_dropout_rounds"] * 2 + ["epoch_tune"] * 2
    resume_dir = _cut_after(straight_dir, str(tmp_path / "jax_cut"), 1)
    jax_resumed, _ = jax_run("jax_resumed", resume_dir=resume_dir)
    tc = _config(tmp_path, "torch_resumed", algorithm_kwargs={**kwargs, "resume_dir": resume_dir}, **OBD_CROSS)
    port_resumed = train(tc, device="cpu")["performance"]
    assert sorted(jax_resumed) == sorted(port_resumed) == [1, 2, 3, 4]
    assert jax_resumed[1] == port_resumed[1] == straight[1]  # restored verbatim
    for r in (2, 3, 4):
        got, want = port_resumed[r], straight[r]
        np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-4)
        assert got["test_accuracy"] == want["test_accuracy"] and got["phase"] == want["phase"]
        np.testing.assert_allclose(got["received_mb"], want["received_mb"], rtol=1e-6)
        np.testing.assert_allclose(got["sent_mb"], want["sent_mb"], rtol=1e-6)
    # the JAX session's documented deviation (2.2643 against 2.2654 at
    # aggregate 2, 2.2619 against 2.2605 at 3), far past that tolerance
    for r in (2, 3):
        assert abs(jax_resumed[r]["test_loss"] - straight[r]["test_loss"]) > 1e-4 * abs(straight[r]["test_loss"]), r


def test_side_state_files_have_the_jax_keys_and_shapes(tmp_path):
    """``opt_state.npz`` (FedOBD) and ``err_state.npz`` (SMAFD) against the
    JAX sessions' own state on the same config (8 workers: the JAX CPU
    mesh's 8 devices pad no slot)."""
    import jax

    from distributed_learning_simulator_tpu.parallel.spmd_obd import SpmdFedOBDSession as JaxOBD
    from distributed_learning_simulator_tpu.parallel.spmd_sparse import SpmdSMAFDSession as JaxSMAFD
    from distributed_learning_simulator_tpu.training import _build_task

    small = dict(worker_number=8, round=1, dataset_kwargs={"train_size": 32, "val_size": 8, "test_size": 8})
    cases = [
        ("fed_obd", {"dropout_rate": 0.3, "second_phase_epoch": 1}, JaxOBD, "opt_state.npz"),
        ("single_model_afd", {"dropout_rate": 0.3}, JaxSMAFD, "err_state.npz"),
    ]
    for algorithm, kwargs, jax_cls, name in cases:
        tc = _config(tmp_path, f"torch_{algorithm}", distributed_algorithm=algorithm, algorithm_kwargs=kwargs, **small)
        train(tc, device="cpu")
        got = _npz(os.path.join(tc.save_dir, "aggregated_model", name))
        jc = jconfig.DistributedTrainingConfig(
            **_fields(tmp_path, f"jax_{algorithm}", distributed_algorithm=algorithm, algorithm_kwargs=kwargs, **small)
        )
        ctx = _build_task(jc)
        session = jax_cls(ctx.config, ctx.dataset_collection, ctx.model_ctx, ctx.engine, ctx.practitioners)
        if name == "opt_state.npz":
            want = {f"leaf_{i}": leaf for i, leaf in enumerate(jax.tree.leaves(session._opt_state_template()))}
            want["stat_key"] = np.int64(2)
            assert int(got["stat_key"]) == 2
        else:
            want = {**session._err_state, "__round__": np.int64(1)}
            assert int(got["__round__"]) == 1
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key].shape == tuple(value.shape), (name, key)
            assert got[key].dtype == np.dtype(value.dtype), (name, key)
