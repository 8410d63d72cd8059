"""The port's sign-SGD session (``parallel/spmd_sign_sgd.py``) against the
JAX package's ``SpmdSignSGDSession``.

* **Lockstep.**  Both packages take the same parameters at every step: the
  JAX trajectory (its engine's gradients, the vote and the update as the
  JAX step body computes them, compiled) drives the port's session step by
  step.  The port's vote may differ from JAX's only on elements where at
  least one voting client's ``|g|`` is at most ``TAU * max|g|`` of its
  leaf: there the two packages' last-bit differences can give the sign of a
  near-zero gradient either way, which moves the vote's sum between 0 and
  +-2 (a "flip"; counted and printed).  The port's update, given JAX's
  direction, matches JAX's within f32 rounding, and the schedule is JAX's.
  One case has unequal client sizes, so some clients' last batch counts 0:
  the step advances all the same and such a client does not vote.
* **Whole runs**, the JAX session's compiled run against the port's, from
  one init: LeNet5 with 8 workers, 2 rounds of 2 epochs (the JAX package's
  ``tests/test_spmd_methods.py`` shape), with and without
  ``random_client_number``, and the IMDB classifier for 1 round (dropout 0
  in both).  A flip moves an element by a whole ``lr`` and the next steps
  train from there, so whole runs are held at stated tolerances (the
  records within ``RUN_RTOL``, at most ``APART_SHARE`` of the final
  parameters beyond f32 rounding) with the flips along the port's
  trajectory counted (the JAX vote taken at the port's parameters every
  step).
* The schedule restarts every round, one K1 launch a step,
  ``best_global_model.npz``, ``round_horizon`` 2 bit-equal to 1, and
  buffered aggregation refused with the JAX session's ``ValueError``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu import training as jtraining
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.models.dropout import dropout_generator
from distributed_learning_simulator_tpu_torch.parallel import spmd_sign_sgd

from test_torch_fed_obd import _no_text_dropout

#: a client's gradient element within TAU of its leaf's largest may take
#: either sign in the two packages
TAU = 1e-5
#: whole runs through vote flips: the records' test loss and train curves
#: (relative), and the share of the final parameters beyond f32 rounding.
#: Measured on the CPU: records 9.9e-4 / 3.0e-3 / 8.1e-8 apart and 5, 264
#: and 54 elements (0.01%, 0.43%, 0.17%) for LeNet5 with 8 and 4 voters
#: and the classifier.  A flip changes the next steps' gradients a little
#: everywhere, so other elements whose vote is a near tie follow it.
RUN_RTOL = 1e-2
APART_SHARE = 1e-2

LENET = dict(dataset_name="MNIST", model_name="LeNet5", worker_number=8, batch_size=16, round=2, epoch=2,
             learning_rate=0.05, dataset_kwargs={"train_size": 256, "val_size": 32, "test_size": 64})
CLASSIFIER = dict(
    dataset_name="imdb", model_name="TransformerClassificationModel", worker_number=4, batch_size=8, round=1,
    epoch=1, learning_rate=0.01,
    dataset_kwargs={"max_len": 16, "vocab_size": 200, "train_size": 64, "val_size": 16, "test_size": 32},
    model_kwargs={"max_len": 16, "d_model": 32, "nhead": 2, "num_encoder_layer": 2},
)


def _configs(tmp_path, task, **extra):
    fields = dict(task, distributed_algorithm="sign_SGD", **extra)
    jc = jconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "jax"), log_file=str(tmp_path / "j.log"))
    tc = tconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "torch"), log_file=str(tmp_path / "t.log"))
    jc.load_config_and_process()
    tc.load_config_and_process()
    return jc, tc


class JaxSign:
    """The JAX session's step body, compiled: every slot's gradient at the
    shared parameters (its engine's ``loss_and_grad``), the vote
    ``sign(sum_c w_c * sign(g_c))``, and the momentum update."""

    def __init__(self, jc) -> None:
        self.session = jtraining._make_spmd_session(jtraining._build_task(jc))
        engine = self.session.engine
        momentum = engine.hyper_parameter.momentum
        self.schedule = engine.hyper_parameter.make_schedule(jc.epoch * self.session.n_batches)

        def vote(params, batch, weights):
            grads = jax.vmap(lambda b: engine.loss_and_grad(params, b, None)[1])(batch)
            total = jax.tree.map(lambda g: jnp.einsum("c,c...->...", weights, jnp.sign(g)), grads)
            return jax.tree.map(jnp.sign, total), grads

        def update(params, velocity, direction, lr):
            velocity = jax.tree.map(lambda v, d: momentum * v + d, velocity, direction)
            params = jax.tree.map(lambda p, v: (p.astype(jnp.float32) - lr * v).astype(p.dtype), params, velocity)
            return params, velocity

        self.vote = jax.jit(vote)
        self.update = jax.jit(update)

    def batch(self, i: int) -> dict:
        return {k: v[i] for k, v in self.session._data.items()}

    def init(self) -> dict:
        return {k: np.asarray(v) for k, v in self.session.engine.init_params(self.session.config.seed).items()}


def _flips(got: dict, want: dict, grads: dict, weights: np.ndarray) -> int:
    """The number of elements where the port's direction ``got`` differs
    from JAX's ``want``; each must have a voting client whose gradient there
    is within ``TAU`` of its leaf's largest magnitude."""
    flips = 0
    voters = np.flatnonzero(weights)
    for key, direction in want.items():
        differ = got[key] != direction
        if not differ.any():
            continue
        g = np.abs(np.asarray(grads[key])[voters])
        scale = g.reshape(len(voters), -1).max(axis=1).reshape((-1,) + (1,) * (g.ndim - 1))
        near_zero = (g <= TAU * scale).any(axis=0)
        assert not (differ & ~near_zero).any(), f"{key}: {int((differ & ~near_zero).sum())} votes differ off the flip rule"
        flips += int(differ.sum())
    return flips



def _port_session(tc, init: dict):
    session = training.build_session(tc, device="cpu")
    session.engine.init_params = lambda seed: convert.from_jax(init)
    return session


def _to_jax(session, flat: torch.Tensor) -> dict:
    return convert.to_jax(session.engine.layout.split(flat))


def _to_port(session, tree: dict) -> torch.Tensor:
    return session.engine.layout.flatten(convert.from_jax({k: np.asarray(v) for k, v in tree.items()}))


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- lockstep
@pytest.mark.parametrize("train_size", [256, 260], ids=["equal_sizes", "unequal_sizes"])
def test_lockstep_vote_and_update_match_jax(tmp_path, train_size):
    jc, tc = _configs(tmp_path, dict(LENET, dataset_kwargs=dict(LENET["dataset_kwargs"], train_size=train_size)))
    ref = JaxSign(jc)
    params = ref.init()
    session = _port_session(tc, params)
    assert session.n_batches == ref.session.n_batches
    counts = np.asarray(session._counts)
    if train_size == 260:  # some clients' last batch counts 0, and they still step
        assert (counts[:, -1] == 0).any() and (counts[:, -1] > 0).any()
    flips, steps = [], 0
    for round_number in (1, 2):
        weights = session.round_weights(round_number)
        np.testing.assert_array_equal(weights, ref.session._round_weights(round_number)[: session.n_slots])
        w = torch.from_numpy(weights)
        jw = jnp.asarray(ref.session._round_weights(round_number))
        votes = session.new_votes(session.engine.layout.size)
        gens = {s: dropout_generator(jc.seed, round_number, s, "cpu") for s in range(session.n_slots)}
        velocity = {k: np.zeros_like(v, np.float32) for k, v in params.items()}
        schedule = session.engine.hyper_parameter.make_schedule(jc.epoch * session.n_batches)
        step = 0
        for _ in range(jc.epoch):
            for i in range(session.n_batches):
                want, grads = ref.vote(params, ref.batch(i), jw)
                got = session.vote(_to_port(session, params), votes, w, weights, i, gens)
                flips.append(_flips(_to_jax(session, got), {k: np.asarray(v) for k, v in want.items()},
                                    {k: np.asarray(v)[: session.n_slots] for k, v in grads.items()}, weights))
                # the update from JAX's direction, velocity and parameters
                lr = ref.schedule(step)
                # the packages' cos differ by an ulp, which 1 + cos magnifies
                # near the end of the period
                np.testing.assert_allclose(schedule(step), np.float32(lr), rtol=1e-5, err_msg=str(step))
                p, v = _to_port(session, params), _to_port(session, velocity)
                session.update(p, v, _to_port(session, want), schedule(step))
                params, velocity = ref.update(params, velocity, want, lr)
                for key, value in _to_jax(session, p).items():
                    np.testing.assert_allclose(value, params[key], rtol=2e-7, atol=1e-7, err_msg=key)
                for key, value in _to_jax(session, v).items():
                    np.testing.assert_allclose(value, velocity[key], rtol=2e-7, atol=1e-7, err_msg=key)
                params = {k: np.asarray(x) for k, x in params.items()}
                velocity = {k: np.asarray(x) for k, x in velocity.items()}
                step += 1
                steps += 1
    size = session.engine.layout.size
    print(f"lockstep ({train_size} samples): {steps} steps, vote flips {flips} of {size} elements a step")
    assert sum(flips) <= 1e-3 * size * steps


# ---------------------------------------------------------------- whole runs
def _run_both(tmp_path, monkeypatch, task, **extra):
    """The JAX session's compiled run and the port's from its init, the
    flips along the port's trajectory counted."""
    jc, tc = _configs(tmp_path, task, **extra)
    ref = JaxSign(jc)
    session = _port_session(tc, ref.init())
    flips = []
    vote = spmd_sign_sgd.SpmdSignSGDSession.vote

    def counted(self, params, votes, w, weights, i, generators, summed=None):
        direction = vote(self, params, votes, w, weights, i, generators, summed)
        jw = np.zeros(ref.session.n_slots, np.float32)
        jw[: len(weights)] = weights
        want, grads = ref.vote(_to_jax(self, params), ref.batch(i), jnp.asarray(jw))
        flips.append(_flips(_to_jax(self, direction), {k: np.asarray(v) for k, v in want.items()},
                            {k: np.asarray(v)[: self.n_slots] for k, v in grads.items()}, weights))
        return direction

    monkeypatch.setattr(spmd_sign_sgd.SpmdSignSGDSession, "vote", counted)
    tres = session.run()["performance"]
    jres = jax_train(jc)["performance"]
    return jc, tc, jres, tres, flips


def _assert_runs_close(jc, tc, jres, tres) -> None:
    """The records within ``RUN_RTOL``, and at most ``APART_SHARE`` of the
    best models' elements beyond f32 rounding (rtol 1e-4, atol 1e-5)."""
    assert sorted(tres) == sorted(jres) == list(range(1, jc.round + 1))
    worst = 0.0
    for r, want in jres.items():
        got = tres[r]
        assert set(want) <= set(got)
        assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 2 / want["test_count"]
        assert got["test_count"] == want["test_count"]
        for key in ("test_loss", "train_loss_per_epoch", "train_accuracy_per_epoch"):
            a, b = np.atleast_1d(got[key]), np.atleast_1d(want[key])
            assert a.shape == b.shape, key
            worst = max(worst, float((np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).max()))
    with open(os.path.join(jc.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        jrec = json.load(f)
    with open(os.path.join(tc.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        trec = json.load(f)
    assert sorted(trec) == sorted(jrec)
    for r in jrec:
        assert set(jrec[r]) <= set(trec[r]) and set(trec[r]) - set(jrec[r]) == {"round_seconds"}
    paths = [os.path.join(c.save_dir, "server", "best_global_model.npz") for c in (jc, tc)]
    apart = size = 0
    with np.load(paths[0]) as want, np.load(paths[1]) as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            apart += int((np.abs(got[key] - want[key]) > 1e-5 + 1e-4 * np.abs(want[key])).sum())
            size += want[key].size
    print(f"  records apart by {worst:.3g} at most (relative); best models: {apart} of {size} elements apart")
    assert worst <= RUN_RTOL and apart <= APART_SHARE * size


@pytest.mark.parametrize("selected", [None, 4], ids=["all", "four_selected"])
def test_lenet5_run_matches_jax(tmp_path, monkeypatch, selected):
    extra = {"algorithm_kwargs": {"random_client_number": selected}} if selected else {}
    jc, tc, jres, tres, flips = _run_both(tmp_path, monkeypatch, LENET, **extra)
    print(f"LeNet5 sign_SGD ({selected or 8} voters): vote flips along the port's run {flips}")
    _assert_runs_close(jc, tc, jres, tres)


def test_classifier_run_matches_jax(tmp_path, monkeypatch):
    _no_text_dropout(monkeypatch)
    jc, tc, jres, tres, flips = _run_both(tmp_path, monkeypatch, CLASSIFIER)
    print(f"classifier sign_SGD: vote flips along the port's run {flips}")
    _assert_runs_close(jc, tc, jres, tres)


# ---------------------------------------------------------------- the pieces
def _session(tmp_path, name, **extra):
    fields = dict(LENET, distributed_algorithm="sign_SGD", save_dir=str(tmp_path / name), **extra)
    fields["dataset_kwargs"] = dict(fields["dataset_kwargs"], train_size=64, test_size=32)
    return training.build_session(tconfig.DistributedTrainingConfig(**fields), device="cpu")


def test_schedule_restarts_each_round_and_k1_launches_once_a_step(tmp_path, monkeypatch):
    session = _session(tmp_path, "steps", round=3)
    lrs, launches = [], []
    update = session.update
    session.update = lambda p, v, d, lr: (lrs.append(float(lr)), update(p, v, d, lr))
    aggregate = spmd_sign_sgd.flat_stack_weighted_sum

    def counted(rows, w):
        launches.append((tuple(rows.shape), rows.dtype, w.tolist()))
        return aggregate(rows, w)

    monkeypatch.setattr(spmd_sign_sgd, "flat_stack_weighted_sum", counted)
    perf = session.run()["performance"]
    steps = session.config.epoch * session.n_batches
    schedule = session.engine.hyper_parameter.make_schedule(steps)
    assert lrs == [float(schedule(s)) for s in range(steps)] * 3
    assert len(launches) == 3 * steps
    assert {shape for shape, _, _ in launches} == {(8, session.engine.layout.size)}
    assert {dtype for _, dtype, _ in launches} == {torch.bfloat16}
    assert all(w == [1.0] * 8 for _, _, w in launches)
    assert sorted(perf) == [1, 2, 3]


def test_votes_are_exact_sums_of_signs(tmp_path):
    """A bf16 row holds -1, 0 and +1 exactly, so K1's f32 sum of the rows is
    the integer vote count."""
    session = _session(tmp_path, "exact")
    votes = session.new_votes(1000)
    rng = np.random.default_rng(0)
    signs = rng.integers(-1, 2, size=(8, 1000)).astype(np.float32)
    votes.copy_(torch.from_numpy(signs))
    weights = np.asarray([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    total = spmd_sign_sgd.flat_stack_weighted_sum(votes, torch.from_numpy(weights))
    np.testing.assert_array_equal(total.numpy(), weights @ signs)
    assert votes.stride(0) % 64 == 0


def test_random_client_number_votes_only_the_selected(tmp_path):
    session = _session(tmp_path, "selected", algorithm_kwargs={"random_client_number": 3}, round=2)
    for r in (1, 2):
        weights = session.round_weights(r)
        assert weights.sum() == 3 and set(np.unique(weights)) <= {0.0, 1.0}
    assert not np.array_equal(session.round_weights(1), session.round_weights(2))


def test_round_horizon_two_is_horizon_one_bit_for_bit(tmp_path):
    runs = {}
    for horizon in (1, 2):
        session = _session(tmp_path, f"h{horizon}", round=3, algorithm_kwargs={"round_horizon": horizon})
        perf = session.run()["performance"]
        with np.load(os.path.join(session.config.save_dir, "server", "best_global_model.npz")) as blob:
            best = {k: blob[k] for k in blob.files}
        runs[horizon] = ({r: {k: v for k, v in row.items() if k != "round_seconds"} for r, row in perf.items()}, best)
    assert runs[2][0] == runs[1][0]
    for key, value in runs[1][1].items():
        np.testing.assert_array_equal(runs[2][1][key], value)


def test_best_global_model_is_the_best_round(tmp_path, monkeypatch):
    """``best_global_model.npz`` is rewritten when test accuracy improves:
    it holds the parameters of the first round with the best accuracy."""
    session = _session(tmp_path, "best", round=3)
    saved = {}
    savez = np.savez

    def recorded(path, **arrays):
        saved[len(session._stat)] = {k: np.array(v) for k, v in arrays.items()}
        return savez(path, **arrays)

    monkeypatch.setattr(spmd_sign_sgd.np, "savez", recorded)
    perf = session.run()["performance"]
    accs = [perf[r]["test_accuracy"] for r in (1, 2, 3)]
    best_round = 1 + int(np.argmax(accs))
    improving = [r for r in (1, 2, 3) if perf[r]["test_accuracy"] > max([-1.0] + accs[: r - 1])]
    assert sorted(saved) == improving and improving[-1] == best_round
    with np.load(os.path.join(session.config.save_dir, "server", "best_global_model.npz")) as blob:
        for key in blob.files:
            np.testing.assert_array_equal(blob[key], saved[best_round][key])


def test_buffered_aggregation_raises_the_jax_error(tmp_path):
    kwargs = {"algorithm_kwargs": {"aggregation_mode": "buffered"}}
    jc, tc = _configs(tmp_path, dict(LENET, round=1, epoch=1), **kwargs)
    with pytest.raises(ValueError) as want:
        jax_train(jc)
    with pytest.raises(ValueError) as got:
        training.train(tc, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kwargs", [{"selection_gather": True}, {"population_store": "streamed"}, {"client_chunk": 2}],
)
def test_unported_keys_raise(tmp_path, kwargs):
    with pytest.raises(NotImplementedError):
        _session(tmp_path, "refused", algorithm_kwargs=kwargs)
