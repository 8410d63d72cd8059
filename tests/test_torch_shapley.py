"""The port's Shapley-value engines (``shapley/``) and session
(``parallel/spmd_shapley.py``) against the JAX package's.

* The engines: each game of the JAX engine tests (``tests/test_shapley.py``)
  over 3 rounds, the metric moving a little each round so that
  ``last_round_metric`` and the between-round truncation carry, with one
  injected metric for both packages: the SV dicts, the best subsets, the
  carried metric and the subsets each engine asks for compared exactly
  (``==``), with and without a batch metric.  ``vp_size``'s errors alike.
* The session, from one JAX init on LeNet5/MNIST: GTG with 4 workers for 2
  rounds, multi-round with 3 workers and ``choose_best_subset``,
  hierarchical with 6 workers (part 3, vp 3): every worker's trained row
  within 1e-5 of the JAX one (relative to the leaf's largest value), the
  same subsets evaluated with equal ``correct`` counts and test losses at
  rtol 1e-5, then ``sv`` / ``sv_S`` equal (they follow from the counts),
  the records' test loss at rtol 1e-5, and ``round_record.json`` with
  round 0.
* K1: once a subset and once a round; and the order of the two
  normalisations (the subset metric sums first, the aggregate normalises
  first).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu import shapley as jshapley
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.parallel import spmd_shapley as jss
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import shapley as tshapley
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.parallel import spmd_shapley as tss
from distributed_learning_simulator_tpu_torch.shapley.base import exact_shapley

ROUNDS = 3
VALUES = {0: 0.05, 1: 0.20, 2: 0.10}
BASE = 0.1


def _additive(subset) -> float:
    return BASE + sum(VALUES[p] for p in subset)


def _coverage_game():
    rng = np.random.default_rng(11)
    skills = {p: set(rng.choice(12, size=4, replace=False).tolist()) for p in range(7)}

    def game(subset) -> float:
        covered = set().union(*(skills[p] for p in subset)) if subset else set()
        return len(covered) / 12.0

    return game


def _linear(scale: float):
    return lambda subset: sum(scale * (p + 1) for p in subset)


def _plateau(subset) -> float:
    """A truncated prefix holds the maximum (``test_gtg_batch_path_same_best_subset``)."""
    return {1: 0.4995, 2: 0.95}.get(len(frozenset(subset)), 0.5)


#: (engine class name, players, last_round_metric, engine kwargs, game)
GAMES = {
    "gtg_additive": ("GTGShapleyValue", list(VALUES), BASE, {"eps": 1e-9, "convergence_threshold": 1e-9}, _additive),
    "gtg_nonadditive": (
        "GTGShapleyValue",
        list(range(7)),
        0.0,
        {"eps": 1e-12, "round_trunc_threshold": 1e-12, "convergence_threshold": 0.0,
         "max_percentage_of_permutations": 0.004, "seed": 5},
        _coverage_game(),
    ),
    "gtg_convergence_bound": (
        "GTGShapleyValue",
        list(range(8)),
        0.1,
        {"eps": 1e-12, "convergence_threshold": 0.05, "seed": 0},
        lambda s: 0.1 + 0.05 * len(s),
    ),
    "gtg_between_round_truncation": (
        "GTGShapleyValue", list(VALUES), _additive(list(VALUES)), {"round_trunc_threshold": 0.5}, _additive,
    ),
    "gtg_best_subset_truncated_prefix": ("GTGShapleyValue", [0, 1, 2], 0.0, {"eps": 0.001, "seed": 3}, _plateau),
    "multiround_exact": ("MultiRoundShapleyValue", list(VALUES), BASE, {}, _additive),
    "multiround_monte_carlo": (
        "MultiRoundShapleyValue", list(range(10)), 0.0, {"mc_permutations": 40, "seed": 7}, _linear(0.01),
    ),
    "hierarchical_mnist_geometry": (
        "HierarchicalShapleyValue", list(range(6)), 0.0, {"part_number": 3, "vp_size": 3, "seed": 5}, _linear(0.02),
    ),
    "hierarchical_monte_carlo_groups": (
        "HierarchicalShapleyValue", list(range(12)), 0.0, {"part_number": 12, "exact_group_limit": 10, "seed": 2},
        _linear(0.01),
    ),
}


def _run_engine(package, name: str, batch: bool):
    """Three rounds of one engine of ``package``; the game drifts by 1e-3 a
    round.  Returns what the engine recorded and every subset it asked for."""
    cls_name, players, last, kwargs, game = GAMES[name]
    engine = getattr(package, cls_name)(players=players, last_round_metric=last, **kwargs)
    asked = []
    for round_number in range(1, ROUNDS + 1):
        drift = 1e-3 * (round_number - 1)

        def metric(subset, drift=drift):
            asked.append(("one", tuple(sorted(int(p) for p in subset))))
            return game(subset) + drift

        def metric_many(subsets, drift=drift):
            asked.append(("many", tuple(tuple(sorted(int(p) for p in s)) for s in subsets)))
            return [game(s) + drift for s in subsets]

        engine.set_metric_function(metric)
        if batch:
            engine.set_batch_metric_function(metric_many)
        engine.compute(round_number=round_number)
    return engine.shapley_values, engine.shapley_values_S, engine.last_round_metric, asked


@pytest.mark.parametrize("batch", [False, True], ids=["sequential", "batch"])
@pytest.mark.parametrize("name", sorted(GAMES))
def test_engine_equals_jax(name, batch):
    got, want = _run_engine(tshapley, name, batch), _run_engine(jshapley, name, batch)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]


@pytest.mark.parametrize("name", ["gtg_additive", "multiround_exact", "hierarchical_mnist_geometry"])
def test_engine_batch_path_equals_sequential(name):
    """Each port engine gives the same values with and without a batch
    metric, as the JAX engine tests require of theirs."""
    batched, plain = _run_engine(tshapley, name, True), _run_engine(tshapley, name, False)
    assert batched[:3] == plain[:3]


def test_engine_exact_helper_equals_jax():
    game = _coverage_game()
    assert exact_shapley(list(range(7)), game) == jshapley.base.exact_shapley(list(range(7)), game)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"vp_size": 0}, {"part_number": 0}, {"part_number": 2, "vp_size": 2}, {"part_number": 1}],
    ids=["neither", "vp_zero", "part_zero", "vp_exceeded", "group_over_12"],
)
def test_hierarchical_vp_size_errors_equal_jax(kwargs):
    players = list(range(13)) if kwargs == {"part_number": 1} else list(range(6))
    with pytest.raises(ValueError) as want:
        jshapley.HierarchicalShapleyValue(players, **kwargs)
    with pytest.raises(ValueError) as got:
        tshapley.HierarchicalShapleyValue(players, **kwargs)
    assert str(got.value) == str(want.value)


def test_engine_kwargs_equal_jax():
    for algorithm in ("Hierarchical_shapley_value", "GTG_shapley_value"):
        config = tconfig.DistributedTrainingConfig(
            distributed_algorithm=algorithm,
            algorithm_kwargs={"part_number": 3, "vp_size": 3, "sv_kwargs": {"seed": 4}, "choose_best_subset": True},
        )
        hierarchical = algorithm.startswith("Hier")
        assert tshapley.sv_engine_kwargs(config, hierarchical) == jshapley.sv_engine_kwargs(config, hierarchical)
    assert tshapley.HIERARCHICAL_CONFIG_KEYS == jshapley.HIERARCHICAL_CONFIG_KEYS


# ---------------------------------------------------------------- the session
def _fields(tmp_path, name, algorithm, workers, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm=algorithm,
        worker_number=workers,
        batch_size=8,
        round=2,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 8 * workers, "val_size": 8, "test_size": 32},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


class _JaxCapture:
    """What the JAX session computed each round: the trained stack, and
    each real subset's ``(loss_sum, correct, count)``."""

    def __init__(self, monkeypatch) -> None:
        self.stacks, self.subsets = [], []
        capture = self
        batch_metric, build_eval = jss.SpmdShapleySession._batch_metric, jss.SpmdShapleySession._build_subset_eval

        def _batch_metric(session, params_s, weights):
            capture.stacks.append({k: np.asarray(v) for k, v in params_s.items()})
            capture.subsets.append({})
            return batch_metric(session, params_s, weights)

        def _build_subset_eval(session):
            subset_eval = build_eval(session)

            def recorded(params_s, masks, weights, batches):
                res = subset_eval(params_s, masks, weights, batches)
                rows = np.asarray(masks)
                for i, row in enumerate(rows):
                    subset = tuple(int(w) for w in np.flatnonzero(row))
                    value = (float(res["loss_sum"][i]), float(res["correct"][i]), float(res["count"][i]))
                    capture.subsets[-1].setdefault(subset, value)
                return res

            return recorded

        monkeypatch.setattr(jss.SpmdShapleySession, "_batch_metric", _batch_metric)
        monkeypatch.setattr(jss.SpmdShapleySession, "_build_subset_eval", _build_subset_eval)


def _run_session(tmp_path, monkeypatch, algorithm, workers, algorithm_kwargs):
    """Both packages' sessions from one JAX init: (JAX result, JAX capture,
    port result, port session, the configs)."""
    init_fields = _fields(tmp_path, "init", algorithm, workers)
    init_config = jconfig.DistributedTrainingConfig(**init_fields)
    ctx = j_create_model(init_config.model_name, j_create_dc(init_config), **init_config.model_kwargs)
    init = str(tmp_path / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()})
    kwargs = dict(algorithm_kwargs, global_model_path=init)
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", algorithm, workers, algorithm_kwargs=kwargs))
    tc = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "torch", algorithm, workers, algorithm_kwargs=dict(kwargs))
    )
    jc.load_config_and_process()
    tc.load_config_and_process()
    capture = _JaxCapture(monkeypatch)
    jres = jax_train(jc)
    stacks = []
    train_stack = tss.SpmdShapleySession.train_stack

    def recorded(session, global_vec, round_number):
        stack = train_stack(session, global_vec, round_number)
        stacks.append(stack.clone())
        return stack

    monkeypatch.setattr(tss.SpmdShapleySession, "train_stack", recorded)
    session = training.build_session(tc, device="cpu")
    tres = session.run()
    return jc, tc, jres, capture, tres, session, stacks


def _records(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


SESSIONS = {
    "gtg_4_workers": ("GTG_shapley_value", 4, {}),
    "multiround_best_subset": ("multiround_shapley_value", 3, {"choose_best_subset": True}),
    "hierarchical_6_workers": ("Hierarchical_shapley_value", 6, {"part_number": 3, "vp_size": 3}),
}


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_matches_jax(tmp_path, monkeypatch, name):
    algorithm, workers, kwargs = SESSIONS[name]
    jc, tc, jres, capture, tres, session, stacks = _run_session(tmp_path, monkeypatch, algorithm, workers, kwargs)
    layout = session.engine.layout
    assert len(stacks) == len(capture.stacks) == jc.round
    for round_index, (stack, jstack) in enumerate(zip(stacks, capture.stacks)):
        for slot in range(workers):
            row = convert.to_jax(layout.split(stack[slot]))
            for key, want in jstack.items():
                rel = np.abs(row[key] - want[slot]).max() / max(np.abs(want[slot]).max(), 1e-30)
                assert rel <= 1e-5, (round_index + 1, slot, key, rel)
    matched = 0
    for round_number, jsubsets in enumerate(capture.subsets, start=1):
        tsubsets = session.subset_results[round_number]
        assert set(tsubsets) <= set(jsubsets), sorted(set(tsubsets) - set(jsubsets))
        # JAX pads a chunk of 16 with dummy subsets; the port evaluates only real ones
        assert session.round_subsets[round_number] == len(tsubsets)
        for subset, (loss_sum, correct, count) in tsubsets.items():
            want = jsubsets[subset]
            assert (correct, count) == want[1:], (round_number, subset)
            np.testing.assert_allclose(loss_sum, want[0], rtol=1e-5, err_msg=str(subset))
            matched += 1
    print(f"{name}: {matched} subsets with equal correct counts; sv {tres['sv']}")
    assert any(v != 0.0 for sv in tres["sv"].values() for v in sv.values())  # not all truncated
    # every subset's count matches, so the engines see equal metrics
    assert tres["sv"] == jres["sv"] and tres["sv_S"] == jres["sv_S"]
    assert len(tres["sv"]) == jc.round and all(len(v) == workers for v in tres["sv"].values())
    assert sorted(tres["performance"]) == sorted(jres["performance"]) == list(range(1, jc.round + 1))
    for r, want in jres["performance"].items():
        got = tres["performance"][r]
        np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-5)
        assert got["test_accuracy"] == want["test_accuracy"]
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec) == [str(r) for r in range(jc.round + 1)]
    np.testing.assert_allclose(trec["0"]["test_loss"], jrec["0"]["test_loss"], rtol=1e-5)
    for key in jrec:
        assert set(jrec[key]) <= set(trec[key]), key
    for name_ in ("shapley_values.json", "shapley_values_S.json"):
        with open(os.path.join(tc.save_dir, name_), encoding="utf8") as f:
            got = json.load(f)
        with open(os.path.join(jc.save_dir, name_), encoding="utf8") as f:
            assert got == json.load(f)
    with np.load(os.path.join(tc.save_dir, "aggregated_model", f"round_{tc.round}.npz")) as blob:
        assert sorted(blob.files) == sorted(capture.stacks[0])


def test_k1_once_a_subset_and_once_a_round(tmp_path, monkeypatch):
    calls = []
    aggregate = tss.flat_stack_weighted_sum

    def counted(rows, w):
        calls.append(tuple(rows.shape))
        return aggregate(rows, w)

    monkeypatch.setattr(tss, "flat_stack_weighted_sum", counted)
    config = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "k1", "GTG_shapley_value", 4))
    session = training.build_session(config, device="cpu")
    result = session.run()
    subsets = sum(session.round_subsets.values())
    assert subsets > 0 and len(calls) == subsets + config.round
    assert set(calls) == {(4, session.engine.layout.size)}
    for r, row in result["performance"].items():
        assert row["subsets"] == session.round_subsets[r]
        assert len(result["sv"][r]) == 4
    assert os.path.isfile(os.path.join(config.save_dir, "shapley_values.json"))
    assert os.path.isfile(os.path.join(config.save_dir, "shapley_values_S.json"))


def test_subset_sums_first_and_the_aggregate_normalises_first(tmp_path):
    """The subset metric's parameters are ``K1(w) / sum(w)``, the round
    aggregate's ``K1(w / sum(w))``, as in the JAX program (its
    ``einsum(w, v) / tw`` and ``einsum(w / tw, v)``).  On these rows the two
    orders give other f32 values, so the test tells them apart."""
    config = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "order", "GTG_shapley_value", 3))
    session = training.build_session(config, device="cpu")
    session._dataset_sizes = np.asarray([3.0, 7.0, 11.0], np.float32)
    rng = np.random.default_rng(0)
    stack = torch.from_numpy(rng.standard_normal((3, 4096)).astype(np.float32))
    ones = np.ones(3, np.float32)
    sized = session._dataset_sizes
    summed = session.subset_params(stack, ones, sized)
    normalised = session.round_aggregate(stack, ones)
    w = torch.from_numpy(sized)
    want_summed = sum(w[c] * stack[c] for c in range(3)) / float(sized.sum())
    want_normalised = sum((w[c] / float(sized.sum())) * stack[c] for c in range(3))
    assert torch.equal(summed, want_summed) and torch.equal(normalised, want_normalised)
    assert not torch.equal(summed, normalised)
    vs = jnp.asarray(stack.numpy())
    jax_subset = np.asarray(jnp.einsum("s,s...->...", jnp.asarray(sized), vs) / jnp.maximum(jnp.sum(jnp.asarray(sized)), 1e-12))
    jax_aggregate = np.asarray(jnp.einsum("s,s...->...", jnp.asarray(sized) / max(float(sized.sum()), 1e-12), vs))
    np.testing.assert_allclose(summed.numpy(), jax_subset, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(normalised.numpy(), jax_aggregate, rtol=1e-6, atol=1e-6)
    # a subset's mask zeroes the others' weights before the sum
    mask = np.asarray([0.0, 1.0, 1.0], np.float32)
    want_subset = (w[1] * stack[1] + w[2] * stack[2]) / float(sized[1] + sized[2])
    assert torch.equal(session.subset_params(stack, mask, sized), want_subset)


@pytest.mark.parametrize(
    "kwargs, error",
    [({"resume_dir": "earlier"}, None), ({"selection_gather": True}, NotImplementedError),
     ({"round_horizon": 2}, ValueError)],
    ids=["resume", "selection_gather", "round_horizon"],
)
def test_unported_keys_raise(tmp_path, kwargs, error):
    """``resume_dir`` is taken (the resume itself: tests/test_torch_resume.py);
    a horizon is refused as the JAX session refuses it (its own round
    program)."""
    config = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "refused", "GTG_shapley_value", 3, algorithm_kwargs=kwargs)
    )
    if error is None:
        session = training.build_session(config, device="cpu")
        assert session.config.algorithm_kwargs == kwargs
        return
    with pytest.raises(error):
        training.build_session(config, device="cpu")
