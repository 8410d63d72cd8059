"""The checkpoint writer, the kill schedule, ``train_with_recovery`` and the
deadline watchdog of the port, on the CPU (the JAX package's
``tests/test_checkpoint.py``, ``tests/test_fault_recovery.py`` and
``tests/test_watchdog.py`` cases, on tiny LeNet5 tasks)."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch import __main__ as cli
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.models.convert import jax_leaves, to_jax
from distributed_learning_simulator_tpu_torch.parallel.spmd import SpmdFedAvgSession
from distributed_learning_simulator_tpu_torch.parallel.spmd_sign_sgd import SpmdSignSGDSession
from distributed_learning_simulator_tpu_torch.parallel.watchdog import DeadlineWatchdog
from distributed_learning_simulator_tpu_torch.training import train, train_with_recovery
from distributed_learning_simulator_tpu_torch.util.checkpoint import AsyncCheckpointWriter, CheckpointError, jax_views
from distributed_learning_simulator_tpu_torch.util.faults import QuorumLostError, SimulatedPreemption
from distributed_learning_simulator_tpu_torch.util.resume import load_resume_state, resumable_round


def _config(tmp_path, name, **extra) -> tconfig.DistributedTrainingConfig:
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
        device="cpu",
    )
    fields.update(extra)
    return tconfig.DistributedTrainingConfig(**fields)


def _record(save_dir) -> dict:
    with open(os.path.join(save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return {int(k): v for k, v in json.load(f).items()}


# ---------------------------------------------------------------- the writer
def test_writer_roundtrip(tmp_path):
    writer = AsyncCheckpointWriter()
    params = {"a": np.arange(6.0), "b": np.ones((2, 3), np.float32)}
    path = str(tmp_path / "ckpt.npz")
    with writer:
        writer.save_npz(path, params)
    with np.load(path) as blob:
        np.testing.assert_array_equal(blob["a"], params["a"])
        np.testing.assert_array_equal(blob["b"], params["b"])
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_save_rows_writes_the_jax_layout_from_staged_copies(tmp_path):
    """One host copy of a flat master in the port's layout lands as the
    JAX package's arrays (a Linear weight transposed back to a Dense
    kernel); rows of a matrix land as ``[S, *shape]``; a buffer is taken
    again only after the write that used it, so later in-place writes to
    the source do not reach a queued file."""
    state = {"fc.weight": torch.arange(6.0).reshape(2, 3), "fc.bias": torch.tensor([7.0, 8.0])}
    keys = sorted(state)
    flat = torch.cat([state[k].reshape(-1) for k in keys])
    leaves = jax_leaves(keys, [tuple(state[k].shape) for k in keys])
    with AsyncCheckpointWriter() as writer:
        for i in range(3):  # three saves through the two buffers
            writer.save_rows(str(tmp_path / f"r{i}.npz"), [flat], lambda host: jax_views(host[0], leaves))
            flat.add_(100.0)  # the next round's in-place update
        rows = torch.stack([flat, -flat])
        writer.save_rows(str(tmp_path / "rows.npz"), [rows[0], None, rows[1]], lambda host: jax_views(host, leaves))
    want = to_jax(state)
    for i in range(3):
        with np.load(tmp_path / f"r{i}.npz") as blob:
            assert sorted(blob.files) == sorted(want)
            for key, value in want.items():
                np.testing.assert_array_equal(blob[key], value + 100.0 * i, err_msg=key)
    with np.load(tmp_path / "rows.npz") as blob:
        assert blob["fc/kernel"].shape == (3, 3, 2)
        np.testing.assert_array_equal(blob["fc/kernel"][1], 0.0)
        np.testing.assert_array_equal(blob["fc/kernel"][2], -blob["fc/kernel"][0])
    assert [t.write_seconds is not None and t.queue_seconds >= 0 for t in writer.timings] == [True] * 4


def test_writer_under_thread_switching_stress(tmp_path):
    """Many saves through the two staging buffers, each followed by an
    in-place write to its source and a promotion, with the interpreter
    switching threads every microsecond: every file holds the values of
    its own save, and the promoted file the last one's."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        source = torch.zeros(4096)
        with AsyncCheckpointWriter() as writer:
            for i in range(40):
                source.fill_(float(i))
                writer.save_rows(str(tmp_path / f"s{i}.npz"), [source, source * 2], lambda host: {"rows": host})
                source.fill_(-1.0)  # the next round's in-place update
                writer.copy_last_to(str(tmp_path / "best.npz"))
        for i in range(40):
            with np.load(tmp_path / f"s{i}.npz") as blob:
                np.testing.assert_array_equal(blob["rows"], np.stack([np.full(4096, i), np.full(4096, 2 * i)]))
        with np.load(tmp_path / "best.npz") as blob:
            np.testing.assert_array_equal(blob["rows"][0], 39.0)
        assert writer._thread is None
    finally:
        sys.setswitchinterval(switch)


def test_writer_copy_last_and_overwrite(tmp_path):
    with AsyncCheckpointWriter() as writer:
        writer.save_npz(str(tmp_path / "round_1.npz"), {"w": np.zeros(3)})
        writer.copy_last_to(str(tmp_path / "best.npz"))
        writer.save_npz(str(tmp_path / "round_2.npz"), {"w": np.ones(3)})
        writer.copy_last_to(str(tmp_path / "best.npz"))
    with np.load(tmp_path / "best.npz") as blob:
        np.testing.assert_array_equal(blob["w"], np.ones(3))
    with pytest.raises(CheckpointError, match="before any save"):
        AsyncCheckpointWriter().copy_last_to(str(tmp_path / "nowhere.npz"))


def test_writer_fails_fast_and_keeps_the_first_error(tmp_path):
    """A failed background save stops the run at the next queue operation
    with its own error, and the promotion chained behind it does not copy
    a stale file left at the source path; the writer works again after."""
    writer = AsyncCheckpointWriter()
    stale = tmp_path / "round_stale.npz"
    np.savez(str(stale), a=np.arange(3.0))
    error = None
    try:
        writer.save_npz(str(tmp_path / "missing" / "round_1.npz"), {"a": np.zeros(2)})
        writer._last_path = str(stale)  # a resumed directory's stale file
        writer.copy_last_to(str(tmp_path / "best.npz"))
    except FileNotFoundError as exc:  # the error can land before any queue operation
        error = exc
    deadline = time.monotonic() + 5.0
    while error is None and time.monotonic() < deadline:
        try:
            writer.save_npz(str(tmp_path / "next.npz"), {"a": np.zeros(2)})
            time.sleep(0.02)
        except FileNotFoundError as exc:
            error = exc
    assert error is not None and "missing" in str(error)
    try:
        writer.wait()
    except FileNotFoundError:
        pass
    assert not (tmp_path / "best.npz").exists()
    with writer:
        writer.save_npz(str(tmp_path / "ok.npz"), {"a": np.zeros(2)})
    assert (tmp_path / "ok.npz").is_file()


def test_writer_thread_stops_after_wait(tmp_path):
    writer = AsyncCheckpointWriter()
    with writer:
        writer.save_npz(str(tmp_path / "a.npz"), {"a": np.zeros(2)})
        thread = writer._thread
    assert writer._thread is None and not thread.is_alive()


def test_resume_ignores_an_orphan_checkpoint(tmp_path):
    """A ``round_N.npz`` without its record row (a crash between the write
    and the row) is not resumed from; the round is trained again."""
    config = _config(tmp_path, "crashed", round=2)
    train(config)
    model_dir = os.path.join(config.save_dir, "aggregated_model")
    with np.load(os.path.join(model_dir, "round_2.npz")) as blob:
        np.savez(os.path.join(model_dir, "round_3.npz"), **{k: blob[k] for k in blob.files})
    assert resumable_round(config.save_dir) == 2
    session = training.build_session(
        _config(tmp_path, "resumed", algorithm_kwargs={"resume_dir": config.save_dir}), device="cpu"
    )
    _, start_round = session._start()
    assert start_round == 3 and sorted(session._stat) == [1, 2]


# ---------------------------------------------------------------- kills and the supervisor
def test_kill_twice_then_finish(tmp_path):
    """Killed after rounds 1 and 3, the run finishes under
    ``train_with_recovery``: the last attempt's record holds every round
    once, and the run is the uninterrupted one, bit for bit."""
    straight = train(_config(tmp_path, "straight"))["performance"]
    result = train_with_recovery(
        _config(tmp_path, "supervised", fault_tolerance={"kill_after_rounds": [1, 3], "restart_backoff_seconds": 0.0})
    )
    recovery = result["recovery"]
    assert recovery["restarts"] == 2
    assert recovery["attempt_dirs"] == [str(tmp_path / d) for d in ("supervised", "supervised_retry1", "supervised_retry2")]
    assert sorted(_record(recovery["save_dir"])) == [1, 2, 3, 4]
    for r in (1, 2, 3, 4):
        assert result["performance"][r]["test_loss"] == straight[r]["test_loss"]


def test_kill_on_sparse_checkpoint_cadence_defers(tmp_path):
    """A kill after a round with no checkpoint (``checkpoint_every`` 2)
    fires at the next checkpointed round, so the resumed run starts past
    it and does not meet it again."""
    config = _config(
        tmp_path, "sparse_kill", checkpoint_every=2,
        fault_tolerance={"kill_after_rounds": [3], "restart_backoff_seconds": 0.0},
    )
    with pytest.raises(SimulatedPreemption, match="after round 3 \\(fired at durable round 4\\)"):
        train(config)
    result = train_with_recovery(config)
    assert sorted(result["performance"]) == [1, 2, 3, 4]
    assert result["recovery"]["restarts"] == 1


def test_kill_on_a_horizon_defers_to_its_boundary(tmp_path):
    """Under ``round_horizon`` 2 the checkpoints, record flushes and kills
    land on the JAX session's horizon boundaries: a kill after round 1
    fires after round 2, whose checkpoint is the only one written."""
    config = _config(tmp_path, "horizon", algorithm_kwargs={"round_horizon": 2},
                     fault_tolerance={"kill_after_rounds": [1]})
    with pytest.raises(SimulatedPreemption, match="fired at durable round 2"):
        train(config)
    assert os.listdir(os.path.join(config.save_dir, "aggregated_model")) == ["round_2.npz"]
    assert sorted(_record(config.save_dir)) == [1, 2]


def test_gives_up_after_the_budget(tmp_path):
    """A fault that fires in every attempt propagates unchanged once
    ``max_restarts`` is spent, after one backoff per restart."""
    calls = []
    with pytest.raises(QuorumLostError):
        train_with_recovery(
            _config(
                tmp_path, "hopeless",
                fault_tolerance={"dropout_schedule": {2: [0, 1, 2]}, "max_restarts": 1, "restart_backoff_seconds": 5.0},
            ),
            sleep_fn=calls.append,
        )
    assert calls == [5.0]


def test_resume_skips_a_torn_checkpoint(tmp_path):
    """A torn newest ``round_N.npz`` falls back to the round before it."""
    config = _config(tmp_path, "torn", round=3)
    train(config)
    path = os.path.join(config.save_dir, "aggregated_model", "round_3.npz")
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    assert resumable_round(config.save_dir) == 2
    params, stats, last = load_resume_state(config.save_dir)
    assert last == 2 and params is not None and sorted(stats) == [1, 2]
    result = train(_config(tmp_path, "torn_resumed", round=3, algorithm_kwargs={"resume_dir": config.save_dir}))
    assert sorted(result["performance"]) == [1, 2, 3]


def test_sign_sgd_restarts_from_round_one(tmp_path, monkeypatch):
    """sign_SGD writes no round checkpoints: its kill fires at once, and the
    supervisor runs it again from round 1.  A scheduled kill therefore
    fires in every attempt until the budget is spent; a one-off crash is
    healed by a run from scratch, the uninterrupted run."""
    sign = dict(distributed_algorithm="sign_SGD", round=2)
    config = _config(
        tmp_path, "sign", fault_tolerance={"kill_after_rounds": [1], "max_restarts": 1, "restart_backoff_seconds": 0.0},
        **sign,
    )
    with pytest.raises(SimulatedPreemption, match="after round 1"):
        train_with_recovery(config)
    for name in ("sign", "sign_retry1"):
        assert sorted(_record(str(tmp_path / name))) == [1]  # each attempt began at round 1
        assert resumable_round(str(tmp_path / name)) == 0

    straight = train(_config(tmp_path, "straight", **sign))["performance"]
    evaluate, crashed = SpmdSignSGDSession._evaluate, []

    def crash_once(self, params):
        if len(self._stat) == 1 and not crashed:  # in round 2 of the first attempt
            crashed.append(True)
            raise RuntimeError("a one-off crash")
        return evaluate(self, params)

    monkeypatch.setattr(SpmdSignSGDSession, "_evaluate", crash_once)
    result = train_with_recovery(_config(tmp_path, "healed", fault_tolerance={"restart_backoff_seconds": 0.0}, **sign))
    assert crashed and result["recovery"]["restarts"] == 1
    assert sorted(result["performance"]) == sorted(_record(result["recovery"]["save_dir"])) == [1, 2]
    for r in (1, 2):
        assert result["performance"][r]["test_loss"] == straight[r]["test_loss"]


@pytest.mark.parametrize(
    "algorithm, extra",
    [
        ("GTG_shapley_value", {}),
        ("fed_gnn", {"dataset_name": "Coauthor_CS", "model_name": "TwoGCN",
                     "dataset_kwargs": {"num_nodes_": 256, "num_features_": 16}}),
    ],
    ids=["shapley", "fed_gnn"],
)
def test_sessions_without_a_kill_point_ignore_the_kill(tmp_path, algorithm, extra):
    """As the JAX Shapley and graph sessions, which call no ``_maybe_kill``."""
    config = _config(tmp_path, "ignored", distributed_algorithm=algorithm, round=2,
                     fault_tolerance={"kill_after_rounds": [1]}, **extra)
    assert sorted(train(config)["performance"]) == [1, 2]


def test_the_cli_runs_auto_resume_under_the_supervisor(monkeypatch):
    calls = []
    monkeypatch.setattr(cli, "train_with_recovery", lambda config: calls.append(("recovery", config)) or {})
    monkeypatch.setattr(cli, "train", lambda config: calls.append(("train", config)) or {})
    base = ["--config-name", "fed_avg/mnist.yaml", "++fed_avg.device=cpu"]
    cli.main([*base, "++fed_avg.fault_tolerance.auto_resume=True"])
    cli.main(base)
    assert [name for name, _ in calls] == ["recovery", "train"]


# ---------------------------------------------------------------- the watchdog
def test_watchdog_unit():
    """The deadline trips with the round and the phase named; the first
    call of a phase gets the grace; an error in the call reaches the
    caller; with 0 seconds the call runs inline."""
    watchdog = DeadlineWatchdog(0.1)
    assert watchdog.call(lambda: time.sleep(0.3) or 42, phase="round", round_number=1) == 42  # inside the grace
    stop = threading.Event()
    with pytest.raises(TimeoutError, match=r"SPMD 'round'.*round 3"):
        watchdog.call(lambda: stop.wait(30), phase="round", round_number=3)
    stop.set()
    with pytest.raises(ValueError, match="boom"):
        watchdog.call(lambda: (_ for _ in ()).throw(ValueError("boom")), phase="eval", round_number=1)
    caller = threading.get_ident()
    assert DeadlineWatchdog(0).call(threading.get_ident, phase="round", round_number=1) == caller


@pytest.mark.parametrize("algorithm", ["fed_avg", "fed_obd"])
def test_a_guarded_run_is_the_unguarded_run(tmp_path, algorithm):
    """Under ``watchdog_seconds`` the round and the evaluation run on the
    watchdog's thread, with the caller's autograd mode: the same run, bit
    for bit."""
    extra = {}
    if algorithm == "fed_obd":
        extra = {"round": 2, "algorithm_kwargs": {"dropout_rate": 0.3, "second_phase_epoch": 1}}
    plain = train(_config(tmp_path, "plain", distributed_algorithm=algorithm, **extra))["performance"]
    guarded = train(_config(tmp_path, "guarded", distributed_algorithm=algorithm, watchdog_seconds=60, **extra))
    for r, row in plain.items():
        assert guarded["performance"][r]["test_loss"] == row["test_loss"]


def test_wedged_round_aborts_under_watchdog_seconds(tmp_path, monkeypatch):
    release = threading.Event()

    def wedged(self, *args, **kwargs):
        release.wait(60)  # a stalled round: never ends within the deadline

    monkeypatch.setattr(SpmdFedAvgSession, "run_round", wedged)
    config = _config(tmp_path, "stall", round=1, watchdog_seconds=0.05)
    try:
        with pytest.raises(TimeoutError, match="SPMD 'round'.*round 1"):
            train(config)
    finally:
        release.set()
