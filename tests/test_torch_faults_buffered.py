"""The fault plan (``util/faults.py``), the update guard, buffered
aggregation (``util/buffered.py``) and ``client_chunk: auto``
(``util/calibration.py``) of the port against the JAX package's.

* ``FaultPlan``'s draws (dropped, straggling and corrupt sets, delays,
  staleness), ``apply_fault_plan``'s weight rows, sleeps and quorum, and
  ``compute_arrival_schedule`` (the overflow cascade included) equal the
  JAX package's for the same configs;
* LeNet5 FedAvg runs of the port's ``train()`` against JAX ``train()``
  from one init: dropout renormalisation, a NaN client rejected by the
  guard, a loose norm guard, buffered aggregation with stragglers and
  overflow (with and without a corrupt client under the guard), and a
  corrupt client without the guard (NaN in both); records (the
  ``rejected_updates`` and flush columns included) and final parameters;
  quorum loss and an all-rejecting norm guard raise ``QuorumLostError``
  after the same records;
* an empty fault config, a plan that injects nothing and a depth-0
  buffered schedule leave the run bit for bit;
* a calibration hit under the port's key, a loud miss on the JAX
  package's key for the same shape, and ``auto`` bit-equal to the chunk it
  resolves to;
* the other sessions refuse buffered aggregation and the guard with the
  JAX package's ``ValueError`` where it refuses them; where it runs a
  fault path (FedOBD's and sign_SGD's guard, FedDropoutAvg's dropout, the
  threaded plan) the port runs it against the JAX package, and where a JAX
  session takes a knob and ignores it the port raises (ROADMAP R18).
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu.util import buffered as jbuffered
from distributed_learning_simulator_tpu.util import calibration as jcalibration
from distributed_learning_simulator_tpu.util import faults as jfaults
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.training import build_session
from distributed_learning_simulator_tpu_torch.training import train as torch_train
from distributed_learning_simulator_tpu_torch.util import buffered as tbuffered
from distributed_learning_simulator_tpu_torch.util import calibration as tcalibration
from distributed_learning_simulator_tpu_torch.util import faults as tfaults

PLANS = {
    "rates": {"seed": 7, "dropout_rate": 0.3, "straggler_rate": 0.25, "corrupt_rate": 0.1,
              "straggler_delay_seconds": 1.0, "straggler_delay_spread": 2.5},
    "schedules": {"dropout_schedule": {"2": [1, 3]}, "straggler_schedule": {1: 0, "3": [2, 5]},
                  "corrupt_schedule": {"4": [2]}, "update_guard": True},
    # conf/fed_avg/mnist_buffered.yaml's
    "shipped": {"seed": 0, "straggler_rate": 0.2, "straggler_delay_seconds": 1.0, "straggler_delay_spread": 1.0},
    # a straggler flag with no delay configured: one flush late
    "flag_only": {"straggler_rate": 0.5, "max_update_norm": 2.0},
}


def _plans(raw):
    holder = type("Config", (), {"fault_tolerance": raw})()
    return jfaults.FaultPlan.from_config(holder), tfaults.FaultPlan.from_config(holder)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plan_draws_match_jax(name):
    jplan, tplan = _plans(PLANS[name])
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tplan.injection_active == jplan.injection_active
    for n in (10, 100):
        for r in range(1, 7):
            assert tplan.dropped_clients(r, n) == jplan.dropped_clients(r, n)
            assert tplan.straggling_clients(r, n) == jplan.straggling_clients(r, n)
            assert tplan.corrupt_clients(r, n) == jplan.corrupt_clients(r, n)
            for w in range(n):
                assert tplan.straggler_delay(r, w, n) == jplan.straggler_delay(r, w, n)
                assert tplan.staleness_rounds(r, w, n) == jplan.staleness_rounds(r, w, n)


def test_fault_plan_config_strictness_matches_jax():
    for raw in ({}, None):
        assert _plans(raw) == (None, None)
    with pytest.raises(ValueError, match="unknown fault_tolerance") as want:
        _plans({"droput_rate": 0.5})[0]
    with pytest.raises(ValueError) as got:
        _plans({"droput_rate": 0.5})[1]
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("quorum", [0, 9])
def test_apply_fault_plan_matches_jax(monkeypatch, name, quorum):
    """The folded weight rows (NaN where corrupt), the straggler sleep and
    the quorum, round by round."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    jplan, tplan = _plans(PLANS[name])
    base = np.asarray([3.0, 0.0, 5.0, 2.0, 4.0, 1.0, 0.0, 6.0, 2.0, 7.0], np.float32)
    for r in range(1, 7):
        outcomes = []
        for module, plan in ((jfaults, jplan), (tfaults, tplan)):
            try:
                outcomes.append(module.apply_fault_plan(plan, quorum, r, None, base.copy(), 10))
            except module.QuorumLostError as error:
                outcomes.append(str(error))
        if isinstance(outcomes[0], str):
            assert outcomes[1] == outcomes[0]
        else:
            np.testing.assert_array_equal(outcomes[1], outcomes[0])
    assert slept[1::2] == slept[0::2]


def _schedules(settings, raw, workers, rounds, selected):
    config = tconfig.DistributedTrainingConfig(
        worker_number=workers, round=rounds, algorithm_kwargs={"random_client_number": selected}
    )
    jplan, tplan = _plans(raw)
    jsched = jbuffered.compute_arrival_schedule(
        jbuffered.BufferedSettings(**settings), jplan, workers, rounds, jbuffered.selection_uploaders(config)
    )
    tsched = tbuffered.compute_arrival_schedule(
        tbuffered.BufferedSettings(**settings), tplan, workers, rounds, tbuffered.selection_uploaders(config)
    )
    return jsched, tsched


@pytest.mark.parametrize(
    "settings,raw,workers,rounds,selected",
    [
        # mnist_buffered.yaml's geometry: 10 workers, 8 selected, buffer 6, 20 rounds
        ({"buffer_size": 6, "staleness_alpha": 0.5}, PLANS["shipped"], 10, 20, 8),
        # the overflow cascade, no faults: 4 uploads into a buffer of 3
        ({"buffer_size": 3, "staleness_alpha": 1.0}, None, 4, 2, None),
        ({"buffer_size": 2, "staleness_alpha": 0.7}, PLANS["rates"], 12, 8, 6),
        ({"staleness_alpha": 0.0}, PLANS["schedules"], 6, 5, None),
    ],
    ids=["shipped", "overflow", "rates", "unbounded"],
)
def test_arrival_schedule_matches_jax(settings, raw, workers, rounds, selected):
    jsched, tsched = _schedules(settings, raw, workers, rounds, selected)
    assert tsched.max_staleness == jsched.max_staleness
    assert tsched.landing == jsched.landing
    assert sorted(tsched.flushes) == sorted(jsched.flushes) == list(range(1, rounds + 1))
    for r, items in jsched.flushes.items():
        assert [dataclasses.astuple(i) for i in tsched.flushes[r]] == [dataclasses.astuple(i) for i in items]
        assert tsched.stale_count(r) == jsched.stale_count(r)
        assert tsched.buffer_depth_after(r) == jsched.buffer_depth_after(r)
        for w in range(workers):
            assert tsched.delay(w, r) == jsched.delay(w, r)


def test_arrival_schedule_overflow_cascades():
    _, sched = _schedules({"buffer_size": 3, "staleness_alpha": 1.0}, None, 4, 2, None)
    assert [(i.worker, i.staleness) for i in sched.cohort(1)] == [(0, 0), (1, 0), (2, 0)]
    assert [(i.worker, i.origin, i.staleness) for i in sched.cohort(2)][0] == (3, 1, 1)
    assert {(w, r) for r in (1, 2) for w in range(4)} - set(sched.landing) == {(2, 2), (3, 2)}


@pytest.mark.parametrize(
    "kwargs",
    [{"aggregation_mode": "sometimes"}, {"buffer_size": 3}, {"aggregation_mode": "buffered", "buffer_size": -1},
     {"aggregation_mode": "buffered", "staleness_alpha": -0.5}],
)
def test_buffered_settings_validation_matches_jax(kwargs):
    config = type("Config", (), {"algorithm_kwargs": kwargs})()
    with pytest.raises(ValueError) as want:
        jbuffered.BufferedSettings.from_config(config)
    with pytest.raises(ValueError) as got:
        tbuffered.BufferedSettings.from_config(config)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ LeNet5 runs
def _fields(tmp_path, name, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm="fed_avg",
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
    """The JAX engine's LeNet5 init params, as an npz."""
    from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
    from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
    from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
    from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model

    path = tmp_path_factory.mktemp("init") / "init.npz"
    config = jconfig.DistributedTrainingConfig(**_fields(path.parent, "init"))
    ctx = j_create_model(config.model_name, j_create_dc(config))
    params = JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return str(path)


def _configs(tmp_path, init_npz, **extra):
    kwargs = {"global_model_path": init_npz, **extra.pop("algorithm_kwargs", {})}
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", algorithm_kwargs=kwargs, **extra))
    tc = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "torch", algorithm_kwargs=kwargs, **extra))
    return jc, tc


def _records(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


def _final_params(config):
    path = os.path.join(config.save_dir, "aggregated_model", f"round_{config.round}.npz")
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


#: columns a record must carry equal in both packages
EXACT = ("test_accuracy", "test_count", "received_mb", "sent_mb", "rejected_updates", "flush_cohort",
         "stale_updates", "buffer_depth")
BUFFERED = {"aggregation_mode": "buffered", "buffer_size": 2, "staleness_alpha": 0.5, "random_client_number": 3}
STRAGGLERS = {"seed": 3, "straggler_rate": 0.4, "straggler_delay_seconds": 1.0, "straggler_delay_spread": 1.5}
RUNS = {
    "dropout": dict(fault_tolerance={"dropout_schedule": {1: [0], 2: [1, 3]}}),
    "guard_rejects_nan_client": dict(fault_tolerance={"corrupt_schedule": {2: [1]}, "update_guard": True}),
    "loose_norm_guard": dict(fault_tolerance={"max_update_norm": 1e3}),
    "buffered": dict(worker_number=5, round=4, algorithm_kwargs=BUFFERED, fault_tolerance=STRAGGLERS),
    "buffered_guard_corrupt": dict(
        worker_number=5, round=4, algorithm_kwargs=BUFFERED,
        fault_tolerance={**STRAGGLERS, "corrupt_schedule": {2: [3]}, "update_guard": True},
    ),
    "corrupt_without_guard": dict(fault_tolerance={"corrupt_schedule": {2: [1]}}),
    "buffered_corrupt_without_guard": dict(
        worker_number=5, round=4, algorithm_kwargs=BUFFERED, fault_tolerance={**STRAGGLERS, "corrupt_schedule": {2: [3]}},
    ),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_fault_trajectory_matches_jax(tmp_path, init_npz, name):
    jc, tc = _configs(tmp_path, init_npz, **RUNS[name])
    jres = jax_train(jc)["performance"]
    tres = torch_train(tc, device="cpu")["performance"]
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec) == [str(r) for r in range(1, jc.round + 1)]
    for r in jrec:
        assert sorted(trec[r]) == sorted(jrec[r]), r
        for key in EXACT:
            if key in jrec[r]:
                assert trec[r][key] == jrec[r][key], (r, key)
    poisoned = "corrupt_without_guard" in name
    for r in jres:
        if poisoned and r >= 2:  # a NaN weight poisons the aggregate visibly, in both
            assert np.isnan(tres[r]["test_loss"]) and np.isnan(jres[r]["test_loss"])
        else:
            np.testing.assert_allclose(tres[r]["test_loss"], jres[r]["test_loss"], rtol=1e-4)
    jparams, tparams = _final_params(jc), _final_params(tc)
    assert sorted(tparams) == sorted(jparams)
    for key, value in jparams.items():
        if poisoned:
            assert np.isnan(tparams[key]).all() and np.isnan(value).all(), key
        else:
            np.testing.assert_allclose(tparams[key], value, rtol=1e-4, atol=1e-5, err_msg=key)
    if name.startswith("guard"):
        assert [trec[r]["rejected_updates"] for r in ("1", "2", "3")] == [0, 1, 0]
    if name.startswith("buffered"):
        # the schedule has late arrivals and an overflow, so the ring is live
        session = build_session(tc, device="cpu")
        assert session._buffered_depth >= 1
        assert any(trec[r]["stale_updates"] for r in trec)
        assert any(trec[r]["flush_cohort"] == 2 for r in trec)


@pytest.mark.parametrize(
    "extra,match",
    [
        (dict(worker_number=4, fault_tolerance={"dropout_schedule": {2: [0, 1, 2]}},
              algorithm_kwargs={"min_client_quorum": 2}), "min_client_quorum=2"),
        (dict(round=2, fault_tolerance={"max_update_norm": 1e-12}), "after update-guard"),
    ],
    ids=["quorum", "norm_guard_rejects_all"],
)
def test_quorum_loss_raises_as_jax(tmp_path, init_npz, extra, match):
    jc, tc = _configs(tmp_path, init_npz, **extra)
    with pytest.raises(jfaults.QuorumLostError, match=match) as want:
        jax_train(jc)
    with pytest.raises(tfaults.QuorumLostError) as got:
        torch_train(tc, device="cpu")
    assert str(got.value) == str(want.value)
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec) == ["1"]
    for key in EXACT:
        if key in jrec["1"]:
            assert trec["1"][key] == jrec["1"][key], key
    np.testing.assert_allclose(trec["1"]["test_loss"], jrec["1"]["test_loss"], rtol=1e-4)
    if "max_update_norm" in extra["fault_tolerance"]:
        assert trec["1"]["rejected_updates"] == 4  # every client: the round kept the init


@pytest.mark.parametrize(
    "extra",
    [
        dict(fault_tolerance={}),
        dict(fault_tolerance={"seed": 5}),
        dict(algorithm_kwargs={"aggregation_mode": "synchronous"}),
        # buffered with no straggler and no overflow: a depth-0 schedule
        dict(algorithm_kwargs={"aggregation_mode": "buffered", "staleness_alpha": 0.5}),
    ],
    ids=["empty", "no_injection", "synchronous", "buffered_depth_0"],
)
def test_fault_machinery_off_is_bit_exact(tmp_path, init_npz, extra):
    _, plain = _configs(tmp_path / "plain", init_npz)
    _, faulted = _configs(tmp_path / "faulted", init_npz, **extra)
    torch_train(plain, device="cpu")
    torch_train(faulted, device="cpu")
    want, got = _final_params(plain), _final_params(faulted)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert sorted(_records(faulted)["1"]) == sorted(_records(plain)["1"])


# ------------------------------------------------------------ calibration
def test_calibration_key_matches_jax():
    args = ("SpmdFedAvgSession", "bert_base", {"clients": 4, "model": 1}, 1000, 104, 32)
    assert tcalibration.calibration_key(*args) == jcalibration.calibration_key(*args)
    assert tcalibration.calibration_key(*args, population_store="streamed") == jcalibration.calibration_key(
        *args, population_store="streamed"
    )


def _write_calibration(path, key, chunk):
    with open(path, "w", encoding="utf8") as f:
        json.dump({"version": 1, "entries": {key: {"client_chunk": chunk}}}, f)
    return str(path)


def test_client_chunk_auto_hits_the_port_key_and_misses_the_jax_key(tmp_path, init_npz):
    """A hit under the port's key (mesh ``{}``) gives the calibrated chunk,
    clamped like a hand-set one (3 -> 2 of 4 slots); the JAX package's key
    for the same shape (its mesh) misses loudly and gives 0, the default."""
    port_key = tcalibration.calibration_key("SpmdFedAvgSession", "LeNet5", {}, 4, 4, 16)
    jax_key = jcalibration.calibration_key("SpmdFedAvgSession", "LeNet5", {"clients": 1, "model": 1}, 4, 4, 16)
    hit = _write_calibration(tmp_path / "hit.json", port_key, 3)
    miss = _write_calibration(tmp_path / "miss.json", jax_key, 3)
    _, hit_config = _configs(tmp_path / "hit", init_npz, algorithm_kwargs={"client_chunk": "auto", "calibration_path": hit})
    session = build_session(hit_config, device="cpu")
    assert tcalibration.session_calibration_key(session) == port_key
    assert (session.client_chunk, session.chunk_size()) == (3, 2)
    _, miss_config = _configs(
        tmp_path / "miss", init_npz, algorithm_kwargs={"client_chunk": "AUTO", "calibration_path": miss}
    )
    session = build_session(miss_config, device="cpu")
    assert (session.client_chunk, session.chunk_size()) == (0, 4)
    with open(miss_config.log_file, encoding="utf8") as f:
        log = f.read()
    assert f"client_chunk: auto found NO calibration entry for {port_key!r}" in log


def test_client_chunk_auto_runs_the_resolved_constant(tmp_path, init_npz):
    key = tcalibration.calibration_key("SpmdFedAvgSession", "LeNet5", {}, 4, 4, 16)
    path = _write_calibration(tmp_path / "calibration.json", key, 2)
    _, auto = _configs(tmp_path / "auto", init_npz, algorithm_kwargs={"client_chunk": "auto", "calibration_path": path})
    _, fixed = _configs(tmp_path / "fixed", init_npz, algorithm_kwargs={"client_chunk": 2})
    torch_train(auto, device="cpu")
    torch_train(fixed, device="cpu")
    want, got = _final_params(fixed), _final_params(auto)
    for key_, value in want.items():
        np.testing.assert_array_equal(got[key_], value, err_msg=key_)


# ------------------------------------------------------------ refusals
#: the sessions the JAX package refuses buffered aggregation on, with the
#: kwargs each needs to build
OTHER_SESSIONS = {
    "fed_dropout_avg": {"dropout_rate": 0.3},
    "single_model_afd": {"dropout_rate": 0.3},
    "GTG_shapley_value": {},
    "fed_obd": {"second_phase_epoch": 1, "dropout_rate": 0.5},
}


def _other_configs(tmp_path, algorithm, algorithm_kwargs, **extra):
    fields = dict(worker_number=2, round=1, distributed_algorithm=algorithm,
                  dataset_kwargs={"train_size": 32, "val_size": 8, "test_size": 16})
    fields.update(extra)
    return (
        jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", algorithm_kwargs=algorithm_kwargs, **fields)),
        tconfig.DistributedTrainingConfig(**_fields(tmp_path, "torch", algorithm_kwargs=algorithm_kwargs, **fields)),
    )


@pytest.mark.parametrize("algorithm", sorted(OTHER_SESSIONS))
def test_other_sessions_refuse_buffered_with_the_jax_error(tmp_path, algorithm):
    kwargs = {**OTHER_SESSIONS[algorithm], "aggregation_mode": "buffered"}
    jc, tc = _other_configs(tmp_path, algorithm, kwargs)
    with pytest.raises(ValueError, match="aggregation_mode=buffered") as want:
        jax_train(jc)
    with pytest.raises(ValueError) as got:
        torch_train(tc, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("algorithm", ["fed_dropout_avg", "single_model_afd", "GTG_shapley_value"])
def test_guard_is_refused_with_the_jax_error(tmp_path, algorithm):
    jc, tc = _other_configs(tmp_path, algorithm, OTHER_SESSIONS[algorithm], fault_tolerance={"update_guard": True})
    with pytest.raises(ValueError, match="update_guard") as want:
        jax_train(jc)
    with pytest.raises(ValueError) as got:
        torch_train(tc, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "algorithm,kwargs,fault_tolerance,executor",
    [
        ("fed_obd", OTHER_SESSIONS["fed_obd"], {"update_guard": True}, "auto"),
        ("sign_SGD", {}, {"update_guard": True}, "auto"),
        ("fed_dropout_avg", {"dropout_rate": 0.3}, {"dropout_rate": 0.5}, "auto"),
        ("fed_avg", {}, {"client_faults_nonfatal": True}, "auto"),
        ("fed_avg", {}, {"auto_resume": True}, "sequential"),
        ("fed_avg", {}, {"dropout_rate": 0.5}, "sequential"),
        ("fed_gnn", {}, {"dropout_rate": 0.5}, "auto"),
    ],
    ids=["fed_obd_guard", "sign_sgd_guard", "sparse_dropout", "nonfatal", "auto_resume", "threaded", "graph"],
)
def test_unported_fault_paths_raise(tmp_path, init_npz, algorithm, kwargs, fault_tolerance, executor):
    """Each fault path where the JAX package runs it: the port runs it and
    its records hold against the JAX package's (``EXACT`` columns equal,
    test loss at rtol 1e-4; sign_SGD from the JAX init at the whole-run
    bound ``RUN_RTOL`` of ``tests/test_torch_sign_sgd.py``; FedDropoutAvg
    with the JAX session's keep masks).  Where a JAX session takes the
    knob and ignores it (``client_faults_nonfatal`` on an SPMD session, the
    plan on the graph sessions), the port raises naming ROADMAP R18."""
    extra = {"dataset_name": "Coauthor_CS", "model_name": "TwoGCN"} if algorithm == "fed_gnn" else {}
    jc, tc = _other_configs(tmp_path, algorithm, kwargs, fault_tolerance=fault_tolerance, executor=executor, **extra)
    if algorithm == "fed_gnn" or "client_faults_nonfatal" in fault_tolerance:
        with pytest.raises(NotImplementedError, match="ROADMAP.md R18"):
            torch_train(tc, device="cpu")
        return
    rtol = 1e-4
    if algorithm == "sign_SGD":  # the session's init is the JAX engine's
        from distributed_learning_simulator_tpu_torch.models import convert

        from test_torch_sign_sgd import RUN_RTOL

        rtol = RUN_RTOL
        session = build_session(tc, device="cpu")
        with np.load(init_npz) as blob:
            init = {k: blob[k] for k in blob.files}
        session.engine.init_params = lambda seed: convert.from_jax(init)
        port_run = session.run
    else:
        for config in (jc, tc):
            config.algorithm_kwargs["global_model_path"] = init_npz
        if algorithm == "fed_dropout_avg":
            from test_torch_sparse import JaxSparseRandom

            tc.endpoint_kwargs = {"worker": {"random": JaxSparseRandom(jc.seed, jc.worker_number)}}

        def port_run():
            return torch_train(tc, device="cpu")

    # a plan can lose a whole round: then both raise the same QuorumLostError after the same records
    errors = []
    for run, lost in ((lambda: jax_train(jc), jfaults.QuorumLostError), (port_run, tfaults.QuorumLostError)):
        try:
            run()
            errors.append(None)
        except lost as exc:
            errors.append(str(exc))
    assert errors[1] == errors[0]
    jrec, trec = ({} if errors[0] and "round 1:" in errors[0] else _records(c) for c in (jc, tc))
    assert sorted(trec) == sorted(jrec) and (jrec or errors[0])
    for r, want in jrec.items():
        for key in EXACT:
            if key in want:
                assert trec[r][key] == want[key], (r, key)
        np.testing.assert_allclose(trec[r]["test_loss"], want["test_loss"], rtol=rtol, err_msg=r)
