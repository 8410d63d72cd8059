"""The threaded executor's fault tolerance (``executor: sequential``) of the
port against the JAX package's, on LeNet5/MNIST from one JAX init through
the weight bridge (``models/convert.py``):

* the fault plan at the upload and the guard at the server: dropout,
  corruption with and without the update guard, a norm guard and
  stragglers (``time.sleep`` mocked in both packages: the same naps);
  records (``rejected_updates``, ``dropped_clients`` and the other
  ``EXACT`` columns equal), test loss at ``LOSS_RTOL`` and the final
  parameters at ``PARAM_RTOL`` / ``PARAM_ATOL`` (the tolerances of
  ``tests/test_torch_faults_buffered.py``);
* quorum loss raising the JAX package's ``QuorumLostError`` after the same
  records; a worker that crashes under ``client_faults_nonfatal`` becoming
  a dropout; the stall watchdog demoting a silent worker (nonfatal) or
  ending the task with a ``TimeoutError`` (a 3 s stall);
* ``parallel_number`` 1: one worker trains at a time, with and without
  unselected rounds, the records as the JAX package's;
* buffered flushes against the JAX threaded run, K1 once a non-empty
  flush, and against the port's own SPMD replay of the same schedule;
  a killed buffered run resumed under ``train_with_recovery`` draining
  its buffer as the JAX package's;
* resume: a killed run resumed by hand equal to the uninterrupted one bit
  for bit, ``train_with_recovery``, SMAFD's residual restore
  (``worker_N/error_feedback.npz``) and FedOBD resuming into phase 2, each
  against the JAX package;
* ``FaultPlan.poison_params`` poisons the JAX package's tensor on the
  tensor's own device and leaves the worker's tensors alone.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu.training import train_with_recovery as jax_train_with_recovery
from distributed_learning_simulator_tpu.util import faults as jfaults
from distributed_learning_simulator_tpu.worker import aggregation_worker as jworker
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.ops import pytree
from distributed_learning_simulator_tpu_torch.util import faults as tfaults
from distributed_learning_simulator_tpu_torch.worker import aggregation_worker as tworker

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
#: the columns a record must carry equal in both packages
EXACT = ("test_accuracy", "test_count", "received_mb", "sent_mb", "rejected_updates", "dropped_clients",
         "flush_cohort", "stale_updates", "buffer_depth", "phase")


def _fields(tmp_path, name, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm="fed_avg",
        executor="sequential",
        worker_number=4,
        batch_size=16,
        round=3,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 128, "val_size": 16, "test_size": 32},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """The JAX engine's LeNet5 init, as an npz both packages load."""
    path = tmp_path_factory.mktemp("threaded_faults_init") / "init.npz"
    config = jconfig.DistributedTrainingConfig(**_fields(path.parent, "init"))
    ctx = j_create_model(config.model_name, j_create_dc(config))
    np.savez(path, **{k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()})
    return str(path)


def _configs(tmp_path, init_npz, **extra):
    kwargs = {"global_model_path": init_npz, **extra.pop("algorithm_kwargs", {})}
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", algorithm_kwargs=dict(kwargs), **extra))
    tc = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "torch", algorithm_kwargs=dict(kwargs), **extra))
    return jc, tc


def _records(save_dir: str) -> dict:
    with open(os.path.join(save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


def _params(save_dir: str, key: int) -> dict:
    with np.load(os.path.join(save_dir, "aggregated_model", f"round_{key}.npz")) as blob:
        return {k: blob[k] for k in blob.files}


def _assert_records_match(jrec: dict, trec: dict, buffered: bool = False) -> None:
    """``buffered``: a flush's ``received_mb`` counts what arrived since the
    last flush, which the worker threads' timing decides, so it is left out."""
    assert sorted(trec) == sorted(jrec)
    for r, want in jrec.items():
        got = trec[r]
        assert set(want) - {"trace_offset"} <= set(got), r
        for key in EXACT:
            if key in want and not (buffered and key == "received_mb"):
                assert got[key] == want[key], (r, key)
        if np.isnan(want["test_loss"]):
            assert np.isnan(got["test_loss"]), r
        else:
            np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=LOSS_RTOL, err_msg=r)


def _assert_params_match(want: dict, got: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if np.isnan(value).any():
            np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(value), err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


@pytest.fixture
def naps(monkeypatch):
    """The straggler sleeps, recorded instead of slept (both packages' time
    module is the one module: a run's naps are those it adds)."""
    got = []
    assert jfaults.time is tfaults.time
    monkeypatch.setattr(tfaults.time, "sleep", got.append)
    return got


def _run_both(jc, tc, naps) -> tuple[list, list]:
    """Each package's run, and the naps each took (sorted: the worker
    threads sleep in any order)."""
    jax_train(jc)
    jax_naps = sorted(naps)
    naps.clear()
    training.train(tc, device="cpu")
    return jax_naps, sorted(naps)


# ------------------------------------------------------------ the plan
STRAGGLE = {"straggler_schedule": {1: [0, 2], 3: [1]}, "straggler_delay_seconds": 0.5, "straggler_delay_spread": 1.0}
RUNS = {
    "dropout": {"dropout_schedule": {1: [0], 2: [1, 3]}},
    "guard_rejects_nan_client": {"corrupt_schedule": {2: [1]}, "update_guard": True},
    "corrupt_without_guard": {"corrupt_schedule": {2: [1]}},
    "norm_guard": {"max_update_norm": 0.057, "dropout_schedule": {3: [2]}},
    "stragglers_dropout_corrupt": {**STRAGGLE, "seed": 4, "dropout_rate": 0.3, "corrupt_rate": 0.2,
                                   "update_guard": True},
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_threaded_fault_trajectory_matches_jax(tmp_path, init_npz, naps, name):
    jc, tc = _configs(tmp_path, init_npz, fault_tolerance=dict(RUNS[name]))
    if name == "corrupt_without_guard":
        # the poisoned aggregate fails the server's finite check, in both
        with pytest.raises(FloatingPointError) as want:
            jax_train(jc)
        with pytest.raises(FloatingPointError) as got:
            training.train(tc, device="cpu")
        assert str(got.value) == str(want.value)
        _assert_records_match(_records(jc.save_dir), _records(tc.save_dir))
        return
    jax_naps, port_naps = _run_both(jc, tc, naps)
    jrec, trec = _records(jc.save_dir), _records(tc.save_dir)
    _assert_records_match(jrec, trec)
    _assert_params_match(_params(jc.save_dir, 3), _params(tc.save_dir, 3))
    assert port_naps == jax_naps
    if name == "guard_rejects_nan_client":
        assert [trec[r]["rejected_updates"] for r in ("1", "2", "3")] == [0, 1, 0]
    if name == "norm_guard":
        assert sum(trec[r]["rejected_updates"] for r in trec) > 0  # the guard bites
    if name.startswith("stragglers"):
        assert port_naps and sum(trec[r]["dropped_clients"] for r in trec) > 0


def test_threaded_quorum_loss_raises_as_jax(tmp_path, init_npz):
    extra = dict(fault_tolerance={"dropout_schedule": {2: [0, 1, 2]}}, algorithm_kwargs={"min_client_quorum": 2})
    jc, tc = _configs(tmp_path, init_npz, **extra)
    with pytest.raises(jfaults.QuorumLostError, match="min_client_quorum=2") as want:
        jax_train(jc)
    with pytest.raises(tfaults.QuorumLostError) as got:
        training.train(tc, device="cpu")
    assert str(got.value) == str(want.value)
    _assert_records_match(_records(jc.save_dir), _records(tc.save_dir))


def _crash_worker_1(module, monkeypatch) -> None:
    original = module.AggregationWorker._get_sent_data

    def faulty(self):
        if self.worker_id == 1 and self._round_num >= 2:
            raise RuntimeError("injected client fault")
        return original(self)

    monkeypatch.setattr(module.AggregationWorker, "_get_sent_data", faulty)


def test_crashed_worker_is_a_dropout_under_nonfatal(tmp_path, init_npz, monkeypatch):
    jc, tc = _configs(tmp_path, init_npz, fault_tolerance={"client_faults_nonfatal": True})
    _crash_worker_1(jworker, monkeypatch)
    _crash_worker_1(tworker, monkeypatch)
    jax_train(jc)
    training.train(tc, device="cpu")
    jrec, trec = _records(jc.save_dir), _records(tc.save_dir)
    _assert_records_match(jrec, trec)
    assert [trec[r]["dropped_clients"] for r in ("1", "2", "3")] == [0, 1, 1]
    _assert_params_match(_params(jc.save_dir, 3), _params(tc.save_dir, 3))


def _mute_worker_1(module, monkeypatch, from_round: int) -> None:
    original = module.AggregationWorker.send_data_to_server

    def muted(self, data):
        if self.worker_id == 1 and self._round_num >= from_round:
            return  # the upload is swallowed: the round barrier never completes
        original(self, data)

    monkeypatch.setattr(module.AggregationWorker, "send_data_to_server", muted)


#: the watchdog's stall threshold in the watchdog test (seconds)
STALL = 3.0


@pytest.mark.parametrize("nonfatal", [True, False], ids=["demote", "abort"])
def test_watchdog_demotes_or_aborts_as_jax(tmp_path, init_npz, monkeypatch, nonfatal):
    """A silent worker from round 2 on: under ``client_faults_nonfatal`` the
    watchdog demotes it and every round completes over the others;
    without, the task ends with the JAX package's ``TimeoutError``.  The
    watchdog waits ``STALL`` seconds: a round of this task, with six test
    processes on eight cores, can go a second or two
    without a message, and that must not trip it."""
    extra = dict(round=3 if nonfatal else 2, watchdog_seconds=STALL)
    if nonfatal:
        extra["fault_tolerance"] = {"client_faults_nonfatal": True}
    jc, tc = _configs(tmp_path, init_npz, **extra)
    _mute_worker_1(jworker, monkeypatch, 2)
    _mute_worker_1(tworker, monkeypatch, 2)
    if not nonfatal:
        with pytest.raises(TimeoutError, match="stalled"):
            jax_train(jc)
        with pytest.raises(TimeoutError, match="stalled"):
            training.train(tc, device="cpu")
        _assert_records_match(_records(jc.save_dir), _records(tc.save_dir))
        return
    jax_train(jc)
    training.train(tc, device="cpu")
    jrec, trec = _records(jc.save_dir), _records(tc.save_dir)
    _assert_records_match(jrec, trec)
    assert [trec[r]["dropped_clients"] for r in ("1", "2", "3")] == [0, 1, 1]
    _assert_params_match(_params(jc.save_dir, 3), _params(tc.save_dir, 3))


@pytest.mark.parametrize("selected", [None, 2], ids=["all", "unselected_rounds"])
def test_parallel_number_one_trains_one_worker_at_a_time(tmp_path, init_npz, selected):
    extra = dict(parallel_number=1)
    if selected:
        extra["algorithm_kwargs"] = {"random_client_number": selected}
    jc, tc = _configs(tmp_path, init_npz, **extra)
    ctx = training.build_task(tc, device="cpu")
    assert ctx.train_slots is not None
    state = {"current": 0, "peak": 0}
    lock = threading.Lock()
    original = ctx.engine.train_epoch

    def tracked(*args, **kwargs):
        with lock:
            state["current"] += 1
            state["peak"] = max(state["peak"], state["current"])
        try:
            return original(*args, **kwargs)
        finally:
            with lock:
                state["current"] -= 1

    ctx.engine.train_epoch = tracked
    training.run_task(ctx)
    assert state["peak"] == 1, state
    jax_train(jc)
    _assert_records_match(_records(jc.save_dir), _records(tc.save_dir))


# ------------------------------------------------------------ buffered
BUFFERED = {"aggregation_mode": "buffered", "buffer_size": 2, "staleness_alpha": 0.5}


def _count_k1(monkeypatch) -> list:
    calls = []
    accum = pytree.weighted_accum

    def counted(x, w):
        calls.append(tuple(x.shape))
        return accum(x, w)

    monkeypatch.setattr(pytree, "weighted_accum", counted)
    return calls


@pytest.mark.parametrize("guard", [False, True], ids=["stragglers", "stragglers_corrupt_guard_quorum"])
def test_threaded_buffered_flushes_match_jax(tmp_path, init_npz, naps, monkeypatch, guard):
    plan = {"seed": 3, "straggler_rate": 0.4, "straggler_delay_seconds": 1.0, "straggler_delay_spread": 1.5}
    kwargs = dict(BUFFERED, random_client_number=3)
    if guard:
        plan.update(corrupt_schedule={2: [3], 3: [0]}, update_guard=True)
        kwargs["min_client_quorum"] = 1
    jc, tc = _configs(tmp_path, init_npz, worker_number=5, round=4, algorithm_kwargs=kwargs, fault_tolerance=plan)
    calls = _count_k1(monkeypatch)
    jax_naps, port_naps = _run_both(jc, tc, naps)
    jrec, trec = _records(jc.save_dir), _records(tc.save_dir)
    _assert_records_match(jrec, trec, buffered=True)
    _assert_params_match(_params(jc.save_dir, 4), _params(tc.save_dir, 4))
    assert any(trec[r]["stale_updates"] for r in trec) and any(trec[r]["buffer_depth"] for r in trec)
    # one K1 launch a flush that merged an upload
    merged = [r for r in trec if trec[r]["flush_cohort"] > trec[r].get("rejected_updates", 0)]
    assert len(calls) == len(merged) > 0
    assert port_naps == jax_naps


def test_threaded_buffered_matches_port_spmd_replay(tmp_path, init_npz):
    """The threaded flushes and the SPMD session's pending ring replay one
    arrival schedule (full participation: both participation rules agree):
    the flush columns equal, the final parameters within 5e-6 of the
    largest (the JAX package's cross-executor bound)."""
    plan = {"seed": 1, "straggler_schedule": {1: [0], 2: [2]}, "straggler_delay_seconds": 0.0}
    sizes = {"train_size": 48, "val_size": 12, "test_size": 32}
    _, threaded = _configs(tmp_path / "threaded", init_npz, worker_number=3, dataset_kwargs=sizes,
                           algorithm_kwargs=dict(BUFFERED), fault_tolerance=dict(plan))
    _, spmd = _configs(tmp_path / "spmd", init_npz, worker_number=3, dataset_kwargs=sizes, executor="spmd",
                       algorithm_kwargs=dict(BUFFERED), fault_tolerance=dict(plan))
    t_perf = training.train(threaded, device="cpu")["performance"]
    s_perf = training.train(spmd, device="cpu")["performance"]
    for r in range(1, 4):
        for column in ("flush_cohort", "stale_updates", "buffer_depth"):
            assert t_perf[r][column] == s_perf[r][column], (r, column)
    assert any(t_perf[r]["stale_updates"] for r in t_perf)
    want, got = _params(spmd.save_dir, 3), _params(threaded.save_dir, 3)
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert max(float(np.abs(got[k] - v).max()) for k, v in want.items()) / scale <= 5e-6


def test_buffered_resume_drains_the_buffer(tmp_path, init_npz):
    """A buffered run killed after round 2 and recovered: the workers
    restart at round 3, no flush waits on an upload from before the kill,
    and round 4 merges worker 2's stale round-3 upload, as in JAX."""
    plan = {"seed": 1, "straggler_schedule": {1: [0], 3: [2]}, "kill_after_rounds": [2], "max_restarts": 2}
    buffered = {"aggregation_mode": "buffered", "staleness_alpha": 0.5}  # unbounded: no overflow past the kill
    jc, tc = _configs(tmp_path, init_npz, round=4, algorithm_kwargs=buffered, fault_tolerance=plan)
    jres = jax_train_with_recovery(jc, sleep_fn=lambda _s: None)
    tres = training.train_with_recovery(tc, sleep_fn=lambda _s: None, device="cpu")
    assert tres["recovery"]["restarts"] == jres["recovery"]["restarts"] == 1
    assert sorted(tres["performance"]) == [1, 2, 3, 4]
    assert tres["performance"][4]["stale_updates"] == 1
    _assert_records_match(_records(jres["recovery"]["save_dir"]), _records(tres["recovery"]["save_dir"]), True)
    _assert_params_match(_params(jres["recovery"]["save_dir"], 4), _params(tres["recovery"]["save_dir"], 4))


# ------------------------------------------------------------ resume
def test_killed_run_resumed_equals_the_uninterrupted_one(tmp_path, init_npz):
    """A run killed after round 2 and resumed by hand from its directory
    ends where the uninterrupted run ends: the records' accuracies equal,
    test losses at ``LOSS_RTOL`` and the parameters at the stated
    tolerance (the server sums uploads in arrival order, which the worker
    threads decide, so not bit for bit)."""
    _, whole = _configs(tmp_path / "whole", init_npz)
    _, killed = _configs(tmp_path / "killed", init_npz, fault_tolerance={"kill_after_rounds": [2]})
    training.train(whole, device="cpu")
    with pytest.raises(tfaults.SimulatedPreemption):
        training.train(killed, device="cpu")
    assert sorted(_records(killed.save_dir)) == ["1", "2"]
    _, resumed = _configs(tmp_path / "resumed", init_npz,
                          algorithm_kwargs={"resume_dir": killed.save_dir})
    perf = training.train(resumed, device="cpu")["performance"]
    assert sorted(perf) == [1, 2, 3]
    _assert_params_match(_params(whole.save_dir, 3), _params(resumed.save_dir, 3))
    _assert_records_match(_records(whole.save_dir), _records(resumed.save_dir))


def test_train_with_recovery_threaded_matches_jax(tmp_path, init_npz):
    plan = {"kill_after_rounds": [2], "restart_backoff_seconds": 0.0}
    jc, tc = _configs(tmp_path, init_npz, fault_tolerance=plan)
    jres = jax_train_with_recovery(jc)
    tres = training.train_with_recovery(tc, device="cpu")
    assert set(tres["performance"]) == {1, 2, 3}
    assert tres["recovery"]["restarts"] == jres["recovery"]["restarts"] == 1
    _assert_records_match(_records(jres["recovery"]["save_dir"]), _records(tres["recovery"]["save_dir"]))
    _assert_params_match(_params(jres["recovery"]["save_dir"], 3), _params(tres["recovery"]["save_dir"], 3))


def test_smafd_residual_restored_on_resume(tmp_path, init_npz):
    """SMAFD resumed at round 2 from a finished 1-round run: each worker
    restores its ``error_feedback.npz`` (tagged 1), so the resumed run ends
    where the uninterrupted 2-round run ends, and it holds against the JAX
    package's resume of the same kind (the JAX session's draws injected,
    ``tests/test_torch_sparse.py``).  A killed run's workers have written
    the next round's residual before the kill lands, so both packages
    restart those at zero (the tag is past the resumable round)."""
    from test_torch_sparse import JaxSparseRandom

    extra = dict(distributed_algorithm="single_model_afd", worker_number=2, epoch=1,
                 dataset_kwargs={"train_size": 48, "val_size": 16, "test_size": 32})
    runs = {}
    for name, rounds, resume in (("whole", 2, None), ("first", 1, None), ("resumed", 2, "first")):
        jc, tc = _configs(tmp_path / name, init_npz, round=rounds, algorithm_kwargs={"dropout_rate": 0.3}, **extra)
        if resume:
            jc.algorithm_kwargs["resume_dir"] = runs[resume][0].save_dir
            tc.algorithm_kwargs["resume_dir"] = runs[resume][1].save_dir
        tc.endpoint_kwargs = {"worker": {"random": JaxSparseRandom(jc.seed, 2)}}
        if name != "whole":
            jax_train(jc)
        training.train(tc, device="cpu")
        runs[name] = (jc, tc)
    jc, tc = runs["resumed"]
    with open(tc.log_file, encoding="utf8") as log:
        assert log.read().count("restored error-feedback residual") == 2
    _assert_params_match(_params(runs["whole"][1].save_dir, 2), _params(tc.save_dir, 2))
    _assert_records_match(_records(jc.save_dir), _records(tc.save_dir))
    _assert_params_match(_params(jc.save_dir, 2), _params(tc.save_dir, 2))


def test_fed_obd_resumes_into_phase_two(tmp_path, init_npz):
    """FedOBD (``second_phase_epoch`` 1) killed after its one phase-1 round:
    the resume replays the driver into phase 2 and the initial broadcast
    tells the new workers, so the tuning epoch runs and is recorded, as in
    JAX (the workers' optimizer state is not restored, in either package,
    so the tuning epoch is not the uninterrupted run's)."""
    extra = dict(distributed_algorithm="fed_obd", worker_number=2, round=1, epoch=1,
                 dataset_kwargs={"train_size": 48, "val_size": 16, "test_size": 32},
                 endpoint_kwargs={"server": {"weight": 0.01}, "worker": {"weight": 0.01}})
    kwargs = {"second_phase_epoch": 1, "dropout_rate": 0.5}
    jc, tc = _configs(tmp_path, init_npz, algorithm_kwargs=dict(kwargs),
                      fault_tolerance={"kill_after_rounds": [1], "restart_backoff_seconds": 0.0}, **extra)
    jres = jax_train_with_recovery(jc)
    tres = training.train_with_recovery(tc, device="cpu")
    assert tres["recovery"]["restarts"] == jres["recovery"]["restarts"] == 1
    final = tres["recovery"]["save_dir"]
    trec = _records(final)
    assert [trec[k]["phase"] for k in sorted(trec)] == ["block_dropout_rounds", "epoch_tune"]
    _assert_records_match(_records(jres["recovery"]["save_dir"]), trec)
    _assert_params_match(_params(jres["recovery"]["save_dir"], 2), _params(final, 2))


# ------------------------------------------------------------ units
def test_poison_params_picks_the_jax_tensor_and_leaves_the_worker_alone(init_npz):
    with np.load(init_npz) as blob:
        jax_params = {k: blob[k] for k in blob.files}
    plan = tfaults.FaultPlan(corrupt_schedule={1: frozenset({0})})
    params = convert.from_jax(jax_params)
    upload = dict(params)
    plan.poison_params(upload)
    poisoned = [k for k, v in upload.items() if torch.isnan(v).any()]
    jplan = jfaults.FaultPlan(corrupt_schedule={1: frozenset({0})})
    jupload = jplan.poison_params(dict(jax_params))
    jpoisoned = [k for k, v in jupload.items() if np.isnan(v).any()]
    assert len(poisoned) == len(jpoisoned) == 1
    assert sorted(convert.to_jax({poisoned[0]: upload[poisoned[0]]})) == jpoisoned
    assert torch.isnan(upload[poisoned[0]]).all() and upload[poisoned[0]].device == params[poisoned[0]].device
    assert not any(torch.isnan(v).any() for v in params.values())  # the worker's tensors


def test_resume_under_a_selection_reaches_every_worker(tmp_path, init_npz):
    """ROADMAP R19: a resumed run under ``random_client_number``.  The JAX
    server sends the workers its initial broadcast leaves out a ``None``,
    so they count from round 1 and wait at the end for a result that never
    comes (its stall watchdog ends the run); the port's tells them the
    round and selects as the uninterrupted run's last result did, and the
    resumed run ends where the uninterrupted one ends."""
    kwargs = {"random_client_number": 2}
    _, whole = _configs(tmp_path / "whole", init_npz, algorithm_kwargs=dict(kwargs))
    jc, killed = _configs(tmp_path / "killed", init_npz, algorithm_kwargs=dict(kwargs),
                          fault_tolerance={"kill_after_rounds": [2]})
    training.train(whole, device="cpu")
    with pytest.raises(tfaults.SimulatedPreemption):
        training.train(killed, device="cpu")
    with pytest.raises(jfaults.SimulatedPreemption):
        jax_train(jc)
    jr, resumed = _configs(tmp_path / "resumed", init_npz, algorithm_kwargs=dict(kwargs, resume_dir=killed.save_dir))
    jr.algorithm_kwargs["resume_dir"] = jc.save_dir
    jr.watchdog_seconds = STALL
    perf = training.train(resumed, device="cpu")["performance"]
    assert sorted(perf) == [1, 2, 3]
    _assert_params_match(_params(whole.save_dir, 3), _params(resumed.save_dir, 3))
    _assert_records_match(_records(whole.save_dir), _records(resumed.save_dir))
    with pytest.raises(TimeoutError, match="stalled"):
        jax_train(jr)
