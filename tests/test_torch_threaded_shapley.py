"""The port's threaded Shapley values (``executor: sequential``,
``method/shapley_value/``) against the JAX package's threaded run, from one
JAX init through the weight bridge, on LeNet5/MNIST at
``tests/test_executor_matrix.py``'s sizes:

* GTG with 3 workers for 2 rounds, multi-round with 3 workers and
  ``choose_best_subset`` for 2 rounds, hierarchical with 6 workers
  (``part_number`` 3, ``vp_size`` 3);
* every upload within ``UPLOAD_RTOL`` of the JAX one (relative to the
  leaf's largest value); the same subsets evaluated with equal ``correct``
  counts (equal accuracies) and test losses at ``LOSS_RTOL`` (the JAX loss
  is its subset program's arithmetic, summed first, on the JAX uploads);
  ``sv`` / ``sv_S`` and both JSON files equal; every record, round 0
  included, at ``LOSS_RTOL``; the telemetry records the JAX server
  writes, round 0's ``init_eval`` span among them;
* against the port's SPMD session: where every worker trains one batch an
  epoch, the same SV dicts; where the threaded workers shuffle several
  batches (the JAX roles' stream) and the session trains them in sampler
  order, the uploads part, and the session's evaluator and engine on the
  threaded stack give the threaded values (the one-line reason below);
* K1 counted through its wrapper: once a subset and once a round;
* the JAX package's ``ValueError`` on ``aggregation_mode: buffered``; the
  round machinery (a kill, a resume, the watchdog, ``parallel_number``)
  against the JAX package on a GTG server, ``sv_batch_chunk``'s refusal
  (item 7), and raising without CUDA.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine.batching import make_epoch_batches as j_make_epoch_batches
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.method.shapley_value import shapley_value_algorithm as jsva
from distributed_learning_simulator_tpu.ml_type import MachineLearningPhase as JPhase
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu.util import faults as jfaults
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import shapley as tshapley
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.method.shapley_value import shapley_value_algorithm as tsva
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.ops import pytree
from distributed_learning_simulator_tpu_torch.util import faults as tfaults
from tools.tracedump import load_trace

#: an upload, relative to its leaf's largest value; a test loss, relative
UPLOAD_RTOL = 1e-5
LOSS_RTOL = 1e-5
#: why the threaded run and the SPMD session part past one batch an epoch
PARTING = "threaded workers shuffle their batches every epoch (the JAX roles' stream); the session trains sampler order"

VISION = dict(batch_size=16, epoch=1, learning_rate=0.05)
CASES = {
    "gtg": ("GTG_shapley_value", 3, 2, {}, {"train_size": 192, "val_size": 32, "test_size": 64}),
    "multiround_best_subset": (
        "multiround_shapley_value", 3, 2, {"choose_best_subset": True},
        {"train_size": 192, "val_size": 32, "test_size": 64},
    ),
    "hierarchical": (
        "Hierarchical_shapley_value", 6, 1, {"part_number": 3, "vp_size": 3},
        {"train_size": 96, "val_size": 16, "test_size": 32},
    ),
}


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(tmp_path, name, case, **extra):
    algorithm, workers, rounds, _, sizes = CASES[case]
    fields = dict(
        VISION,
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm=algorithm,
        executor="sequential",
        worker_number=workers,
        round=rounds,
        dataset_kwargs=dict(sizes),
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
        telemetry={"enabled": True},
    )
    fields.update(extra)
    return fields


def _jax_init(tmp_path, case) -> str:
    """The JAX engine's init of the task, as an npz both packages load."""
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "init", case))
    ctx = j_create_model(jc.model_name, j_create_dc(jc))
    path = str(tmp_path / "init.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()})
    return path


def _configs(tmp_path, case, init, **extra):
    kwargs = dict(CASES[case][3], global_model_path=init)
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", case, algorithm_kwargs=dict(kwargs), **extra))
    tc = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "torch", case, algorithm_kwargs=dict(kwargs), **extra))
    jc.load_config_and_process()
    tc.load_config_and_process()
    return jc, tc


class _JaxCapture:
    """What the JAX threaded server saw each round: the uploads, each
    subset's accuracy, the subset's test loss by the JAX subset program's
    arithmetic (summed first, its test batches), and ``sv_S``."""

    def __init__(self, monkeypatch) -> None:
        self.uploads, self.subsets, self.sv_S = [], [], {}
        capture = self
        aggregate, many, one = (jsva.ShapleyValueAlgorithm.aggregate_worker_data,
                                jsva.ShapleyValueAlgorithm._get_subset_metrics,
                                jsva.ShapleyValueAlgorithm._get_subset_metric)

        def recorded_aggregate(self):
            capture.uploads.append(
                {w: {k: np.asarray(v) for k, v in d.parameter.items()} for w, d in self._all_worker_data.items()}
            )
            capture.subsets.append({})
            result = aggregate(self)
            capture.sv_S.update(self.shapley_values_S)
            return result

        def record(self, subsets, values):
            data = self._all_worker_data
            workers = sorted(data)
            weights = np.asarray([float(data[w].dataset_size) for w in workers], np.float32)
            test = self._server.tester.dataset_collection.get_dataset(JPhase.Test)
            batches = j_make_epoch_batches(test, self.config.batch_size)
            for subset, value in zip(subsets, values):
                w = jnp.asarray(np.asarray([weights[i] if workers[i] in set(subset) else 0.0
                                            for i in range(len(workers))], np.float32))
                params = {
                    k: jnp.einsum("w,w...->...", w, jnp.stack([jnp.asarray(data[c].parameter[k]) for c in workers]))
                    / jnp.maximum(jnp.sum(w), 1e-12)
                    for k in data[workers[0]].parameter
                }
                out = self._server.tester.engine.evaluate(params, batches)
                loss = float(out["loss_sum"]) / max(float(out["count"]), 1.0)
                capture.subsets[-1][tuple(sorted(int(p) for p in subset))] = (float(value), loss)

        def recorded_many(self, subsets):
            values = many(self, subsets)
            record(self, subsets, values)
            return values

        def recorded_one(self, subset):
            value = one(self, subset)
            record(self, [subset], [value])
            return value

        monkeypatch.setattr(jsva.ShapleyValueAlgorithm, "aggregate_worker_data", recorded_aggregate)
        monkeypatch.setattr(jsva.ShapleyValueAlgorithm, "_get_subset_metrics", recorded_many)
        monkeypatch.setattr(jsva.ShapleyValueAlgorithm, "_get_subset_metric", recorded_one)


def _port_capture(monkeypatch) -> list:
    """Each round's stack of uploads as the port's server holds it."""
    stacks = []
    aggregate = tsva.ShapleyValueAlgorithm.aggregate_worker_data

    def recorded(self):
        stacks.append((self.stack.clone(), self.stack_sizes.copy()))
        return aggregate(self)

    monkeypatch.setattr(tsva.ShapleyValueAlgorithm, "aggregate_worker_data", recorded)
    return stacks


def _run_port(tc):
    """The port's threaded run on the CPU: (result, its server's algorithm)."""
    ctx = training.build_task(tc, device="cpu")
    return training.run_task(ctx), ctx.server.algorithm


def _trace_kinds(config) -> list[tuple]:
    """The trace's records as (record, kind, round), the JAX package's
    one-sided ``compile`` and ``program_cost`` left out."""
    records = load_trace(os.path.join(config.save_dir, "server", "trace.jsonl"))
    return [(r["ev"], r["kind"], r.get("round")) for r in records if r["kind"] not in ("compile", "program_cost")]


def _records(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_threaded_matches_jax_threaded(tmp_path, monkeypatch, case):
    jc, tc = _configs(tmp_path, case, _jax_init(tmp_path, case))
    capture = _JaxCapture(monkeypatch)
    jres = jax_train(jc)
    stacks = _port_capture(monkeypatch)
    tres, algorithm = _run_port(tc)
    layout = algorithm.subsets.engine.layout
    workers = tc.worker_number
    assert len(stacks) == len(capture.uploads) == tc.round
    for round_index, ((stack, sizes), uploads) in enumerate(zip(stacks, capture.uploads)):
        assert sorted(uploads) == list(range(workers)) and np.all(sizes > 0)
        for worker, want in uploads.items():
            row = convert.to_jax(layout.split(stack[worker]))
            for key, value in want.items():
                rel = np.abs(row[key] - value).max() / max(np.abs(value).max(), 1e-30)
                assert rel <= UPLOAD_RTOL, (round_index + 1, worker, key, rel)
    matched = 0
    for round_number, jsubsets in enumerate(capture.subsets, start=1):
        tsubsets = algorithm.subsets.results[round_number]
        assert set(tsubsets) == set(jsubsets)
        assert algorithm.subsets.round_subsets[round_number] == len(tsubsets)
        for subset, (loss_sum, correct, count) in tsubsets.items():
            accuracy, loss = jsubsets[subset]
            assert float(np.float32(correct) / np.float32(count)) == accuracy, (round_number, subset)
            np.testing.assert_allclose(loss_sum / count, loss, rtol=LOSS_RTOL, err_msg=str(subset))
            matched += 1
    print(f"{case}: {matched} subsets with equal correct counts; sv {tres['sv']}")
    assert any(v != 0.0 for sv in tres["sv"].values() for v in sv.values())  # not all truncated
    assert tres["sv"] == jres["sv"] and tres["sv_S"] == capture.sv_S
    assert all(sorted(sv) == list(range(workers)) for sv in tres["sv"].values())
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec) == [str(r) for r in range(tc.round + 1)]
    # the JAX server's telemetry: uploads, barriers, round 0's init_eval, round spans
    assert _trace_kinds(tc) == _trace_kinds(jc)
    assert ("span", "init_eval", 0) in _trace_kinds(tc)
    for key, want in jrec.items():
        assert set(want) <= set(trec[key]), key
        np.testing.assert_allclose(trec[key]["test_loss"], want["test_loss"], rtol=LOSS_RTOL, err_msg=key)
        assert trec[key]["test_accuracy"] == want["test_accuracy"], key
    assert sorted(tres["performance"]) == sorted(jres["performance"]) == list(range(tc.round + 1))
    names = ["shapley_values.json"] + (["shapley_values_S.json"] if "choose_best_subset" in CASES[case][3] else [])
    for name in names:
        with open(os.path.join(tc.save_dir, name), encoding="utf8") as got, open(
            os.path.join(jc.save_dir, name), encoding="utf8"
        ) as want:
            assert json.load(got) == json.load(want)
    assert not os.path.exists(os.path.join(tc.save_dir, "shapley_values_S.json")) or len(names) == 2


def _spmd_session(tc):
    """The port's SPMD session on ``tc``'s task."""
    return training.build_session(dataclasses.replace(tc, executor="spmd", save_dir=tc.save_dir + "_spmd"),
                                  device="cpu")


def test_threaded_matches_port_spmd_at_one_batch_an_epoch(tmp_path, monkeypatch):
    """A worker's one batch an epoch (batch 128, the largest worker holds
    67 samples) holds the same samples in either order, so the two
    executors train the same rows up to summation order."""
    _, tc = _configs(tmp_path, "gtg", _jax_init(tmp_path, "gtg"), batch_size=128)
    tres, _ = _run_port(tc)
    spmd = _spmd_session(tc).run()
    assert tres["sv"] == spmd["sv"] and tres["sv_S"] == spmd["sv_S"]
    for r, row in spmd["performance"].items():
        np.testing.assert_allclose(tres["performance"][r]["test_loss"], row["test_loss"], rtol=LOSS_RTOL)
        assert tres["performance"][r]["subsets"] == row["subsets"]


def test_threaded_parts_from_port_spmd_past_one_batch(tmp_path, monkeypatch):
    """PARTING: with 4 batches an epoch the uploads part from the session's
    rows, and the session's evaluator and engine on the threaded stack give
    the threaded run's values."""
    _, tc = _configs(tmp_path, "gtg", _jax_init(tmp_path, "gtg"), round=1)
    stacks = _port_capture(monkeypatch)
    tres, _ = _run_port(tc)
    rows = []
    session = _spmd_session(tc)
    session_stack = session.train_stack(session._start()[0], 1)
    stack, sizes = stacks[0]
    apart = float((session_stack - stack).abs().max() / stack.abs().max())
    assert apart > UPLOAD_RTOL, PARTING
    engine = tshapley.GTGShapleyValue(players=list(range(3)), last_round_metric=tres["performance"][0]["test_accuracy"])
    metric_many = session._metric_many(stack, sizes, 99)
    engine.set_metric_function(lambda subset: metric_many([subset])[0])
    engine.set_batch_metric_function(metric_many)
    engine.compute(round_number=1)
    rows.append(engine.shapley_values[1])
    assert rows[0] == tres["sv"][1], PARTING


def test_k1_once_a_subset_and_once_a_round(tmp_path, monkeypatch):
    calls = []
    accum = pytree.weighted_accum

    def counted(x, w):
        calls.append(tuple(x.shape))
        return accum(x, w)

    monkeypatch.setattr(pytree, "weighted_accum", counted)
    _, tc = _configs(tmp_path, "gtg", _jax_init(tmp_path, "gtg"))
    tres, algorithm = _run_port(tc)
    subsets = sum(row["subsets"] for key, row in tres["performance"].items() if key)
    assert subsets == sum(algorithm.subsets.round_subsets.values()) > 0
    assert len(calls) == subsets + tc.round
    assert set(calls) == {(3, algorithm.subsets.engine.layout.size)}


@pytest.mark.parametrize("algorithm", ["GTG_shapley_value", "fed_gnn"])
def test_buffered_raises_the_jax_value_error(tmp_path, algorithm):
    fields = dict(
        distributed_algorithm=algorithm, executor="sequential", worker_number=2, round=1,
        algorithm_kwargs={"aggregation_mode": "buffered"},
        **({"dataset_name": "MNIST", "model_name": "LeNet5",
            "dataset_kwargs": {"train_size": 32, "val_size": 8, "test_size": 8}}
           if algorithm.startswith("GTG") else
           {"dataset_name": "Cora", "model_name": "TwoGCN", "dataset_kwargs": {"num_nodes_": 64}}),
    )
    with pytest.raises(ValueError) as want:
        jax_train(jconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "jax")))
    with pytest.raises(ValueError) as got:
        training.train(tconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "torch")), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "fields",
    [{"fault_tolerance": {"kill_after_rounds": [1]}}, {"algorithm_kwargs": {"resume_dir": "earlier"}},
     {"watchdog_seconds": 5.0}, {"parallel_number": 2}, {"algorithm_kwargs": {"aggregation_mode": "synchronous",
                                                                               "sv_batch_chunk": 4}}],
    ids=["fault_plan", "resume", "watchdog", "parallel_number", "sv_batch_chunk"],
)
def test_round_machinery_stays_refused(tmp_path, fields):
    """The threaded round machinery on a Shapley server, against the JAX
    package on the same config: a kill after round 1 raises the JAX
    package's ``SimulatedPreemption`` after the same records; a resume of a
    directory with nothing to resume, the watchdog and ``parallel_number``
    run the task as JAX runs it (records' accuracies equal, test losses at
    ``LOSS_RTOL``).  ``sv_batch_chunk`` stays refused (ROADMAP item 7)."""
    if "sv_batch_chunk" in fields.get("algorithm_kwargs", {}):
        config = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "refused", "gtg", **fields))
        with pytest.raises(NotImplementedError, match="item 7"):
            training.train(config, device="cpu")
        return
    extra = dict(fields)
    jc, tc = _configs(tmp_path, "gtg", _jax_init(tmp_path, "gtg"), **{k: v for k, v in extra.items()
                                                                      if k != "algorithm_kwargs"})
    for config in (jc, tc):
        config.algorithm_kwargs.update(extra.get("algorithm_kwargs", {}))
    if "fault_tolerance" in extra:
        with pytest.raises(jfaults.SimulatedPreemption) as want:
            jax_train(jc)
        with pytest.raises(tfaults.SimulatedPreemption) as got:
            training.train(tc, device="cpu")
        assert str(got.value) == str(want.value)
    else:
        jax_train(jc)
        training.train(tc, device="cpu")
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec)
    for key, want_row in jrec.items():
        np.testing.assert_allclose(trec[key]["test_loss"], want_row["test_loss"], rtol=LOSS_RTOL, err_msg=key)
        assert trec[key]["test_accuracy"] == want_row["test_accuracy"], key


def test_raises_without_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "cuda", "gtg"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.train(config)
