"""The port's roundtrace telemetry (``util/telemetry.py``) against the JAX
package's on the same configs (LeNet5 on MNIST, 2 workers, 64 training
samples, a few rounds, the JAX engine's init for both):

* telemetry off is the run without the key, bit for bit, and writes no
  trace; on, it changes no parameter and no record field but
  ``trace_offset`` and the wall times;
* at H = 1 (synchronous, and buffered with stragglers) the traces hold the
  same ``(ev, kind)`` records but ``compile`` and ``program_cost``, the same
  ``round`` span fields (accuracy and loss at rtol 1e-4, the trajectory
  tolerance of ``test_torch_fed_avg.py``), the same ``tools.tracedump``
  budget block, and the sessions' ``dispatch_count``, ``host_sync_count``
  and ``rounds_run`` are equal;
* at H = 4 the ``round`` and ``horizon`` span counts, the chunks and the
  wire totals agree (the port's rounds make the H = 1 dispatches);
* ``fault`` events under one fault plan equal the JAX package's and the
  chaos counters of the record rows;
* the threaded executor's, FedOBD's and sign_SGD's record sequences equal
  the JAX package's;
* a killed run recovered by ``train_with_recovery`` appends to one trace
  whose offsets continue; a torn tail is repaired as the JAX recorder
  repairs it;
* the config errors and the ``profile_rounds`` window match the JAX
  package's (on the CPU ``torch.profiler`` writes its file), and
  ``profile: true`` writes the run's profile;
* the graph sessions write no trace; ``tools.costview`` renders the
  port's trace; a kernel library's load is one ``compile`` event a trace.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.training import _build_task as jax_build_task
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu.util import telemetry as jtelemetry
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.training import build_session
from distributed_learning_simulator_tpu_torch.training import train as torch_train
from distributed_learning_simulator_tpu_torch.training import train_with_recovery
from distributed_learning_simulator_tpu_torch.util import telemetry as ttelemetry
from tools.tracedump import load_trace, summarize

#: the record kinds only one package makes: the JAX package's jit
#: compiles against the port's kernel-library loads, and their pricing
ONE_SIDED = ("compile", "program_cost")
#: the budget block's keys both packages must agree on
BUDGET = (
    "rounds_total",
    "dispatches_total",
    "dispatches_per_round",
    "host_syncs_total",
    "host_syncs_per_round",
    "sent_mb_total",
    "received_mb_total",
    "rejected_updates_total",
    "dropped_clients_total",
    "stale_updates_total",
)
#: test_torch_fed_avg.py's trajectory tolerance
RTOL = 1e-4
ON = {"enabled": True}


def _fields(tmp_path, name, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm="fed_avg",
        worker_number=2,
        batch_size=32,
        round=2,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
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


def _configs(tmp_path, init_npz=None, telemetry=ON, **extra):
    kwargs = dict(extra.pop("algorithm_kwargs", {}))
    if init_npz is not None:
        kwargs["global_model_path"] = init_npz
    configs = []
    for module, name in ((jconfig, "jax"), (tconfig, "torch")):
        config = module.DistributedTrainingConfig(**_fields(tmp_path, name, algorithm_kwargs=dict(kwargs), **extra))
        config.telemetry = dict(telemetry)
        configs.append(config)
    return configs


def _trace(config) -> list[dict]:
    return load_trace(os.path.join(config.save_dir, "server", "trace.jsonl"))


def _record(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


def _kinds(records) -> list[tuple[str, str]]:
    return [(r["ev"], r["kind"]) for r in records if r["kind"] not in ONE_SIDED]


def _spans(records, kind="round") -> list[dict]:
    return [r for r in records if r["ev"] == "span" and r["kind"] == kind]


def _jax_session(config):
    from distributed_learning_simulator_tpu.parallel.spmd import SpmdFedAvgSession

    ctx = jax_build_task(config)
    return SpmdFedAvgSession(ctx.config, ctx.dataset_collection, ctx.model_ctx, ctx.engine, ctx.practitioners)


def _assert_cross_links(config) -> None:
    """Every record row's ``trace_offset`` is the line of its own round
    span, and every record's ``i`` is its line index."""
    path = os.path.join(config.save_dir, "server", "trace.jsonl")
    with open(path, encoding="utf8") as f:
        lines = f.read().splitlines()
    records = load_trace(path)
    assert [r["i"] for r in records] == list(range(len(lines)))
    for key, row in _record(config).items():
        span = json.loads(lines[row["trace_offset"]])
        assert (span["ev"], span["kind"], span["round"]) == ("span", "round", int(key))
        assert span["accuracy"] == row["test_accuracy"]


def _assert_round_spans_match(jrecords, trecords) -> None:
    jspans, tspans = _spans(jrecords), _spans(trecords)
    assert len(tspans) == len(jspans) > 0
    for j, t in zip(jspans, tspans):
        assert set(t) - {"t", "i", "dur"} == set(j) - {"t", "i", "dur"}
        for key in set(j) - {"t", "i", "dur", "accuracy", "loss"}:
            assert t[key] == j[key], key
        for key in ("accuracy", "loss"):
            np.testing.assert_allclose(t[key], j[key], rtol=RTOL)


def _assert_budgets_match(jrecords, trecords) -> None:
    jbudget, tbudget = summarize(jrecords)["budget"], summarize(trecords)["budget"]
    for key in BUDGET:
        assert tbudget[key] == pytest.approx(jbudget[key], rel=1e-12), key


# ---------------------------------------------------------------- FedAvg
def test_telemetry_off_is_bit_exact_and_fileless(tmp_path, init_npz):
    """A run without the key, one with ``enabled: false`` and one with it
    on: the same parameters bit for bit, the same record rows but for the
    wall times (and the on-run's ``trace_offset``), a trace only when on."""
    runs = {}
    for name, telemetry in (("absent", None), ("off", {"enabled": False}), ("on", ON)):
        config = tconfig.DistributedTrainingConfig(
            **_fields(tmp_path, name, algorithm_kwargs={"global_model_path": init_npz})
        )
        if telemetry is not None:
            config.telemetry = telemetry
        torch_train(config, device="cpu")
        with np.load(os.path.join(config.save_dir, "aggregated_model", "round_2.npz")) as blob:
            params = {k: blob[k] for k in blob.files}
        runs[name] = (config, params, _record(config))
    absent = runs["absent"]
    for name in ("off", "on"):
        config, params, record = runs[name]
        assert params.keys() == absent[1].keys()
        for key in params:
            np.testing.assert_array_equal(params[key], absent[1][key])
        for key, row in record.items():
            row = dict(row)
            assert ("trace_offset" in row) == (name == "on")
            row.pop("trace_offset", None)
            assert set(row) == set(absent[2][key])
            assert {k: v for k, v in row.items() if k != "round_seconds"} == {
                k: v for k, v in absent[2][key].items() if k != "round_seconds"
            }
        assert os.path.isfile(os.path.join(config.save_dir, "server", "trace.jsonl")) == (name == "on")
    assert not os.path.exists(os.path.join(absent[0].save_dir, "server", "trace.jsonl"))


BUFFERED = dict(
    worker_number=4,
    round=3,
    algorithm_kwargs={"aggregation_mode": "buffered", "buffer_size": 2, "staleness_alpha": 0.5},
    fault_tolerance={"seed": 3, "straggler_rate": 0.4, "straggler_delay_seconds": 1.0, "straggler_delay_spread": 1.5},
)


@pytest.mark.parametrize("case", ["synchronous", "buffered"])
def test_h1_trace_matches_jax(tmp_path, init_npz, case):
    """At H = 1: the same record sequence (buffered: the ``staleness`` and
    ``buffer_flush`` events too), the same round spans, the same budget
    block and the same counters; both files round-trip through tracedump
    and cross-link their rows."""
    jc, tc = _configs(tmp_path, init_npz, **(BUFFERED if case == "buffered" else {}))
    jc.load_config_and_process()
    jsession, tsession = _jax_session(jc), build_session(tc, device="cpu")
    jsession.run()
    tsession.run()
    jrecords, trecords = _trace(jc), _trace(tc)
    assert _kinds(trecords) == _kinds(jrecords)
    if case == "buffered":
        assert ("event", "staleness") in _kinds(trecords)
        assert _same_events(jrecords, trecords, ("staleness", "buffer_flush"))
        assert summarize(trecords)["staleness"] == summarize(jrecords)["staleness"]
    _assert_round_spans_match(jrecords, trecords)
    _assert_budgets_match(jrecords, trecords)
    counters = lambda s: (s.dispatch_count, s.host_sync_count, s.rounds_run)  # noqa: E731
    assert counters(tsession) == counters(jsession) == (3 * jc.round, jc.round, jc.round)
    assert [r["program"] for r in _spans(trecords, "dispatch_call")] == [
        r["program"] for r in _spans(jrecords, "dispatch_call")
    ]
    (cost,) = [r for r in trecords if r["kind"] == "program_cost"]
    assert cost["flops"] > 0 and cost["argument_bytes"] > 0
    _assert_cross_links(tc)
    tsession.reset_dispatch_stats()
    assert counters(tsession) == (0, 0, 0)


def _same_events(jrecords, trecords, kinds) -> bool:
    strip = lambda r: {k: v for k, v in r.items() if k not in ("i", "t")}  # noqa: E731
    return [strip(r) for r in trecords if r["kind"] in kinds] == [strip(r) for r in jrecords if r["kind"] in kinds]


def test_horizon_spans_match_jax(tmp_path, init_npz):
    """H = 4 over 6 rounds (chunks [1, 4] and [5, 6]): the same round and
    horizon spans and wire totals; the port's rounds each make the H = 1
    dispatches and host sync, under the JAX horizon program's name."""
    jc, tc = _configs(tmp_path, init_npz, round=6, algorithm_kwargs={"round_horizon": 4})
    jax_train(jc)
    torch_train(tc, device="cpu")
    jrecords, trecords = _trace(jc), _trace(tc)
    field = lambda r: (r["first_round"], r["last_round"], r["rounds"])  # noqa: E731
    assert [field(r) for r in _spans(trecords, "horizon")] == [field(r) for r in _spans(jrecords, "horizon")]
    assert [field(r) for r in _spans(trecords, "horizon")] == [(1, 4, 4), (5, 6, 2)]
    _assert_round_spans_match(jrecords, trecords)
    jbudget, tbudget = summarize(jrecords)["budget"], summarize(trecords)["budget"]
    for key in ("rounds_total", "sent_mb_total", "received_mb_total"):
        assert tbudget[key] == pytest.approx(jbudget[key], rel=1e-12)
    assert (tbudget["dispatches_total"], tbudget["host_syncs_total"]) == (18, 6)
    assert (jbudget["dispatches_total"], jbudget["host_syncs_total"]) == (2, 2)
    programs = [r["program"] for r in _spans(trecords, "dispatch_call")]
    assert programs == ["horizon[h=4]"] * 4 + ["horizon[h=2]"] * 2
    _assert_cross_links(tc)


def test_fault_events_match_jax_and_the_chaos_counters(tmp_path, init_npz):
    """One fault plan in both packages: the ``fault`` events equal, carry
    the record rows' ``rejected_updates``, and count the plan's dropped
    clients among the selected."""
    from distributed_learning_simulator_tpu_torch.util.faults import FaultPlan
    from distributed_learning_simulator_tpu_torch.utils.selection import select_workers

    plan = {"seed": 1, "dropout_rate": 0.4, "corrupt_schedule": {2: [0]}, "update_guard": True}
    jc, tc = _configs(
        tmp_path, init_npz, worker_number=4, round=3, fault_tolerance=plan, algorithm_kwargs={"min_client_quorum": 1}
    )
    jax_train(jc)
    torch_train(tc, device="cpu")
    jrecords, trecords = _trace(jc), _trace(tc)
    assert _same_events(jrecords, trecords, ("fault",))
    faults = {r["round"]: r for r in trecords if r["kind"] == "fault"}
    assert set(faults) == {1, 2, 3}
    rows = _record(tc)
    tplan = FaultPlan.from_config(tc)
    for rn in (1, 2, 3):
        assert faults[rn]["rejected_updates"] == rows[str(rn)]["rejected_updates"]
        selected = set(select_workers(tc.seed, rn, tc.worker_number, None))
        assert faults[rn]["dropped_clients"] == len(tplan.dropped_clients(rn, tc.worker_number) & selected)
    assert faults[2]["rejected_updates"] >= 1
    _assert_budgets_match(jrecords, trecords)
    _assert_round_spans_match(jrecords, trecords)


# ----------------------------------------------------- the other executors
def test_threaded_trace_matches_jax(tmp_path, init_npz):
    """The threaded executor: ``upload`` events, a ``round_barrier`` span a
    round and cross-linked ``round`` spans, as the JAX server writes them."""
    jc, tc = _configs(tmp_path, init_npz, executor="sequential")
    jax_train(jc)
    torch_train(tc, device="cpu")
    jrecords, trecords = _trace(jc), _trace(tc)
    assert _kinds(trecords) == _kinds(jrecords)
    tsummary = summarize(trecords)
    assert tsummary["meta"]["executor"] == "sequential"
    assert tsummary["spans"]["round_barrier"]["count"] == 2
    assert tsummary["events"] == summarize(jrecords)["events"] == {"upload": 4}
    for j, t in zip(_spans(jrecords), _spans(trecords)):
        assert set(t) == set(j) and t["round"] == j["round"]
    _assert_cross_links(tc)


def test_fed_obd_trace_matches_jax(tmp_path):
    """FedOBD, one phase-1 round and one tuning epoch: the same records
    (the ``phase_switch`` events among them), round spans with the phase,
    and the JAX phase programs' names."""
    extra = dict(
        distributed_algorithm="fed_obd", round=1, batch_size=8,
        algorithm_kwargs={"second_phase_epoch": 1, "dropout_rate": 0.5},
    )
    jc, tc = _configs(tmp_path, **extra)
    jax_train(jc)
    torch_train(tc, device="cpu")
    jrecords, trecords = _trace(jc), _trace(tc)
    assert _kinds(trecords) == _kinds(jrecords)
    assert _same_events(jrecords, trecords, ("phase_switch",))
    assert [r["phase"] for r in _spans(trecords)] == ["block_dropout_rounds", "epoch_tune"]
    assert [r["program"] for r in _spans(trecords, "dispatch_call")] == ["phase1[dense]", "phase2[dense]"]
    assert [r["program"] for r in _spans(jrecords, "dispatch_call")] == ["phase1[dense]", "phase2[dense]"]
    _assert_cross_links(tc)


def test_sign_sgd_trace_matches_jax(tmp_path):
    """sign_SGD: the JAX session's records a round (``run[gather]`` under
    selection), and the trace on disk after every round."""
    extra = dict(distributed_algorithm="sign_SGD", worker_number=4, algorithm_kwargs={"random_client_number": 2})
    jc, tc = _configs(tmp_path, **extra)
    jax_train(jc)
    torch_train(tc, device="cpu")
    jrecords, trecords = _trace(jc), _trace(tc)
    assert _kinds(trecords) == _kinds(jrecords)
    assert [r["program"] for r in _spans(trecords, "dispatch_call")] == ["run[gather]"] * 2
    assert [r["program"] for r in _spans(jrecords, "dispatch_call")] == ["run[gather]"] * 2
    _assert_budgets_match(jrecords, trecords)


def test_graph_session_writes_no_trace(tmp_path):
    """As the JAX graph sessions, which never read ``config.telemetry``."""
    config = tconfig.DistributedTrainingConfig(
        dataset_name="Coauthor_CS",
        model_name="TwoGCN",
        distributed_algorithm="fed_gnn",
        worker_number=2,
        round=1,
        epoch=1,
        batch_size=32,
        dataset_kwargs={"num_nodes_": 128, "num_features_": 8},
        save_dir=str(tmp_path / "gnn"),
        log_file=str(tmp_path / "gnn.log"),
        telemetry=dict(ON),
    )
    torch_train(config, device="cpu")
    assert os.path.isfile(os.path.join(config.save_dir, "server", "round_record.json"))
    assert not os.path.exists(os.path.join(config.save_dir, "server", "trace.jsonl"))


# --------------------------------------------------- recovery and the sink
def test_recovered_run_appends_one_trace(tmp_path, init_npz):
    """A kill after round 1 of 3, recovered: both attempts append to the
    first attempt's trace, every record's ``i`` is its line, the second
    attempt starts with its meta record and a ``resume`` event, and every
    row of the final record cross-links a round span of that file."""
    config = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "killed", round=3, algorithm_kwargs={"global_model_path": init_npz}),
        fault_tolerance={"kill_after_rounds": [1], "restart_backoff_seconds": 0.0},
        telemetry=dict(ON),
    )
    result = train_with_recovery(config, device="cpu")
    assert result["recovery"]["restarts"] == 1
    path = os.path.join(config.save_dir, "server", "trace.jsonl")
    assert not os.path.exists(os.path.join(result["recovery"]["save_dir"], "server", "trace.jsonl"))
    with open(path, encoding="utf8") as f:
        lines = f.read().splitlines()
    records = [json.loads(line) for line in lines]
    assert [r["i"] for r in records] == list(range(len(lines)))
    metas = [r["i"] for r in records if r["ev"] == "meta"]
    assert len(metas) == 2
    assert [r["round"] for r in records if r["kind"] == "resume"] == [2]
    assert [r["round"] for r in _spans(records)] == [1, 2, 3]
    final = dataclasses.replace(config, save_dir=result["recovery"]["save_dir"])
    for key, row in _record(final).items():
        span = records[row["trace_offset"]]
        assert (span["kind"], span["round"]) == ("round", int(key))
    assert sum(r["kind"] == "program_cost" for r in records) == 1  # priced once a trace


def test_torn_tail_is_repaired_as_jax(tmp_path):
    """The same appends in both packages, a torn line between two
    recorders: the same offsets and the same repaired file."""
    lines = {}
    for name, module in (("jax", jtelemetry), ("torch", ttelemetry)):
        path = str(tmp_path / f"{name}.jsonl")
        first = module.TraceRecorder(enabled=True, path=path, flush_every=1)
        offsets = [first.event("dispatch", program="round", round=1)]
        with open(path, "at") as f:
            f.write('{"i": 2, "t"')  # a crash mid-append
        second = module.TraceRecorder(enabled=True, path=path, flush_every=1)
        offsets.append(second.event("dispatch", program="round", round=2))
        records = load_trace(path)
        lines[name] = (offsets, [r["i"] for r in records], [(r["ev"], r["kind"]) for r in records])
        with open(path, encoding="utf8") as f:
            assert f.read().endswith("\n")
    assert lines["torch"] == lines["jax"]
    assert lines["torch"][:2] == ([1, 4], [0, 1, 3, 4])


def test_compile_events_once_a_library_and_trace(tmp_path, monkeypatch):
    """Each kernel library loaded in the process is one ``compile`` event
    in a trace (one loaded before the recorder too), and a recorder that
    continues the trace reports no library again."""
    from distributed_learning_simulator_tpu_torch.ops import build

    monkeypatch.setattr(build, "loads", [{"library": "weighted_accum", "seconds": 0.5, "built": True}])
    path = str(tmp_path / "t.jsonl")
    first = ttelemetry.TraceRecorder(enabled=True, path=path, flush_every=1)
    build.loads.append({"library": "short_attention", "seconds": 0.25, "built": False})
    first.event("dispatch", program="round", round=1)
    first.close()
    second = ttelemetry.TraceRecorder(enabled=True, path=path, flush_every=1)
    build.loads.append({"library": "qsgd", "seconds": 0.1, "built": False})
    second.event("dispatch", program="round", round=2)
    records = load_trace(path)
    compiles = [(r["program"], r["retrace"], r["built"]) for r in records if r["kind"] == "compile"]
    assert compiles == [("weighted_accum", False, True), ("short_attention", False, False), ("qsgd", False, False)]
    assert first.counters["compile"] == 2 and second.counters["compile"] == 1
    assert summarize(records)["budget"]["compile_events"] == 3
    assert summarize(records)["budget"]["retrace_events"] == 0


# ------------------------------------------------- config and the profiler
@pytest.mark.parametrize("telemetry", [{"enabled": True, "typo_knob": 3}, {"enabled": True, "profile_rounds": [3, 1]},
                                       {"profile_rounds": [0, 2]}, {"profile_rounds": [1, 2, 3]}])
def test_config_errors_match_jax(tmp_path, telemetry):
    holder = type("Config", (), {"telemetry": telemetry, "save_dir": str(tmp_path)})()
    with pytest.raises(ValueError) as want:
        jtelemetry.TraceRecorder.from_config(holder)
    with pytest.raises(ValueError) as got:
        ttelemetry.TraceRecorder.from_config(holder)
    assert str(got.value) == str(want.value)


def test_profile_window_snaps_as_jax(tmp_path, monkeypatch):
    """The window's gating against the JAX recorder's (its profiler
    stubbed): a window inside a chunk opens and closes at the chunk's
    ends, chunks before or after it open nothing; the port's window
    writes its Chrome trace on the CPU."""
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    actions = {}
    for name, module in (("jax", jtelemetry), ("torch", ttelemetry)):
        inside = module.TraceRecorder(enabled=True, path=str(tmp_path / f"{name}_in.jsonl"), flush_every=1,
                                      profile_rounds=(2, 3))
        inside.maybe_profile_start(1, 4)
        inside.maybe_profile_stop(4)
        outside = module.TraceRecorder(enabled=True, path=str(tmp_path / f"{name}_out.jsonl"), flush_every=1,
                                       profile_rounds=(5, 6))
        outside.maybe_profile_start(1, 4)
        outside.maybe_profile_start(7, 8)
        outside.close()
        actions[name] = [
            [(r["action"], r["round"]) for r in load_trace(str(tmp_path / f"{name}_{w}.jsonl")) if r["kind"] == "profile"]
            for w in ("in", "out")
        ]
    assert actions["torch"] == actions["jax"] == [[("start", 1), ("stop", 4)], []]
    (stop,) = [r for r in load_trace(str(tmp_path / "torch_in.jsonl")) if r.get("action") == "stop"]
    assert os.path.isfile(stop["file"]) and os.path.dirname(stop["file"]) == str(tmp_path / "profile_rounds")


def test_profile_rounds_and_profile_write_their_files(tmp_path):
    """``profile: true``: the run's Chrome trace under ``<save_dir>/profile``
    (a ``profile_rounds`` window beside it is skipped); ``profile_rounds:
    [2, 2]`` alone on a 3-round run: start and stop events at round 2 and
    one Chrome trace under ``server/profile_rounds``."""
    config = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "window", round=3), telemetry={"enabled": True, "profile_rounds": [2, 2]}, profile=True
    )
    torch_train(config, device="cpu")
    # profile: true holds the profiler, so the window is skipped (one profiler at a time)
    assert not [r for r in _trace(config) if r["kind"] == "profile"]
    (profile,) = os.listdir(os.path.join(config.save_dir, "profile"))
    assert profile.startswith("run.") and profile.endswith(".pt.trace.json")
    config = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "window_only", round=3), telemetry={"enabled": True, "profile_rounds": [2, 2]}
    )
    torch_train(config, device="cpu")
    records = _trace(config)
    assert [(r["action"], r["round"]) for r in records if r["kind"] == "profile"] == [("start", 2), ("stop", 2)]
    files = os.listdir(os.path.join(config.save_dir, "server", "profile_rounds"))
    assert len(files) == 1 and files[0].startswith("rounds_2-2.")


# ---------------------------------------------------------------- readers
def test_costview_and_tracedump_read_the_port_trace(tmp_path, init_npz, capsys):
    """``python -m tools.costview`` and ``python -m tools.tracedump`` on a
    port trace: the priced round program, the rounds' wall and the budget."""
    from tools.costview import attribute
    from tools.costview.__main__ import main as costview_main
    from tools.tracedump.__main__ import main as tracedump_main

    config = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "view", algorithm_kwargs={"global_model_path": init_npz}), telemetry=dict(ON)
    )
    torch_train(config, device="cpu")
    path = os.path.join(config.save_dir, "server", "trace.jsonl")
    view = attribute(load_trace(path))
    assert view["programs"]["round[dense]"]["flops"] > 0
    assert view["programs"]["round[dense]"]["calls"] == 2
    assert costview_main([path, "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out.strip())
    assert payload["programs"]["round[dense]"]["flops"] == view["programs"]["round[dense]"]["flops"]
    assert tracedump_main([path, "--assert-budget", "dispatches_per_round==3"]) == 0
    assert "rounds=2" in capsys.readouterr().out
