"""The port's FedDropoutAvg and SMAFD (``parallel/spmd_sparse.py``) against
the JAX package's SPMD sessions.

* Trajectories from one JAX init on LeNet5/MNIST (4 workers, 2 rounds, 2
  local epochs: the best-epoch validation runs), with full participation
  and with 2 clients a round, the port fed the JAX session's own draws
  (:class:`JaxSparseRandom`: the keep masks' uniforms and SMAFD's leaf
  orders, rebuilt from the JAX key chain): every record's test loss at
  rtol 1e-4, accuracy and wire MB equal, and the final npz at rtol 1e-4 /
  atol 1e-5.  SMAFD with its leaf budget and with ``topk_ratio``.
* The pieces: JAX's ``bernoulli`` is its uniform below ``p`` in f32 (what
  the port compares); an element every selected client dropped becomes 0;
  an unselected slot's residual is carried unchanged; the budget's greedy
  in f32 picks JAX's leaves where f64 sums would not; ``topk_ratio``'s
  threshold admits ties as ``lax.top_k`` does.
* ``conf/fed_dropout_avg/imdb.yaml`` and ``conf/smafd/imdb.yaml`` through
  both packages' ``load_config``, unmodified but for sizes, against the
  JAX package (``test_torch_fed_obd_files.py``'s way).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.ops import quantization as tq
from distributed_learning_simulator_tpu_torch.parallel import spmd_sparse

from test_torch_fed_obd import JaxSessionRandom, _no_text_dropout

ROUNDS = 2
WORKERS = 4


class JaxSparseRandom(JaxSessionRandom):
    """The JAX FedAvg session's key chain (``rng, round_rng = split(rng)`` a
    round, ``fold_in(round_rng, worker)`` a client) and the sparse
    sessions' draws from the second half of a client's split: FedDropoutAvg
    keeps leaf ``i`` where ``uniform(fold_in(half, i)) < 1 - rate``; SMAFD
    orders its leaves by ``permutation(half, n)``."""

    def __init__(self, seed: int, worker_number: int) -> None:
        super().__init__("paq", seed, worker_number)

    def _half(self, aggregate: int, slot: int):
        round_rng, _ = self._round(aggregate)
        return jax.random.split(jax.random.fold_in(round_rng, slot))[1]

    def dropout_uniform(self, seed, aggregate, slot, leaf, count, shape, device):
        key = jax.random.fold_in(self._half(aggregate, slot), leaf)
        return torch.from_numpy(np.array(jax.random.uniform(key, tuple(shape))))

    def leaf_permutation(self, seed, aggregate, slot, count):
        return np.asarray(jax.random.permutation(self._half(aggregate, slot), count))


def _fields(tmp_path, name, algorithm, **extra):
    fields = dict(
        dataset_name="MNIST",
        model_name="LeNet5",
        distributed_algorithm=algorithm,
        worker_number=WORKERS,
        batch_size=8,
        round=ROUNDS,
        epoch=2,
        learning_rate=0.05,
        dataset_kwargs={"train_size": 64, "val_size": 16, "test_size": 32},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


def _records(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


def _final(config) -> dict:
    with np.load(os.path.join(config.save_dir, "aggregated_model", f"round_{config.round}.npz")) as blob:
        return {k: blob[k] for k in blob.files}


def _assert_match(jc, tc, jres, tres) -> None:
    assert sorted(tres) == sorted(jres) == list(range(1, jc.round + 1))
    for key in jres:
        got, want = tres[key], jres[key]
        np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-4)
        assert got["test_accuracy"] == want["test_accuracy"]
        np.testing.assert_allclose(got["received_mb"], want["received_mb"], rtol=1e-6)
        np.testing.assert_allclose(got["sent_mb"], want["sent_mb"], rtol=1e-6)
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec)
    for key in jrec:
        assert set(jrec[key]) <= set(trec[key]), key  # the port adds test_count
    got, want = _final(tc), _final(jc)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)


def _run_both(tmp_path, algorithm, algorithm_kwargs, **extra):
    """Both packages' SPMD sessions from one JAX init, the port fed the
    JAX draws; returns the configs and the results."""
    init_config = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "init", algorithm, **extra))
    ctx = j_create_model(init_config.model_name, j_create_dc(init_config), **init_config.model_kwargs)
    init = str(tmp_path / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()})
    kwargs = dict(algorithm_kwargs, global_model_path=init)
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", algorithm, algorithm_kwargs=kwargs, **extra))
    endpoint = {"worker": {"random": JaxSparseRandom(jc.seed, jc.worker_number)}}
    tc = tconfig.DistributedTrainingConfig(
        **_fields(tmp_path, "torch", algorithm, algorithm_kwargs=dict(kwargs), endpoint_kwargs=endpoint, **extra)
    )
    jc.load_config_and_process()
    tc.load_config_and_process()
    jres = jax_train(jc)["performance"]
    tres = training.train(tc, device="cpu")["performance"]
    return jc, tc, jres, tres



@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The port's small ops on one intra-op thread: the test workers share
    the machine's cores, and many threads over tiny tensors mostly wait
    on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# ---------------------------------------------------------------- trajectories
@pytest.mark.parametrize("selected", [None, 2], ids=["all", "two_selected"])
def test_fed_dropout_avg_trajectory_matches_jax(tmp_path, selected):
    kwargs = {"dropout_rate": 0.3}
    if selected:
        kwargs["random_client_number"] = selected
    _assert_match(*_run_both(tmp_path, "fed_dropout_avg", kwargs))


@pytest.mark.parametrize(
    "kwargs",
    [{"dropout_rate": 0.5}, {"dropout_rate": 0.5, "random_client_number": 2}, {"topk_ratio": 0.1}],
    ids=["budget", "budget_two_selected", "topk"],
)
def test_smafd_trajectory_matches_jax(tmp_path, kwargs):
    _assert_match(*_run_both(tmp_path, "single_model_afd", kwargs))


# ---------------------------------------------------------------- the pieces
@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4, 5)])
@pytest.mark.parametrize("rate", [0.3, 0.5, 0.9])
def test_jax_bernoulli_is_its_flat_uniform_below_p_in_f32(shape, rate):
    """What the port computes from the injected draws: JAX's keep mask is
    ``uniform(key, n) < f32(1 - rate)`` in the leaf's flat order."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    want = np.asarray(jax.random.bernoulli(key, p=1.0 - rate, shape=shape)).reshape(-1)
    uniform = torch.from_numpy(np.array(jax.random.uniform(key, (int(np.prod(shape)),))))
    got = (uniform < torch.tensor(np.float32(1.0 - rate))).numpy()
    np.testing.assert_array_equal(got, want)


class _FixedDraws(tq.CodecRandom):
    """Keep every element but those of leaf ``dropped`` (JAX order)."""

    def __init__(self, dropped: int) -> None:
        self.dropped = dropped

    def dropout_uniform(self, seed, aggregate, slot, leaf, count, shape, device):
        return torch.full(tuple(shape), 1.0 if leaf == self.dropped else 0.0)


def _session(tmp_path, name, algorithm, **fields):
    config = tconfig.DistributedTrainingConfig(**_fields(tmp_path, name, algorithm, **fields))
    return training.build_session(config, device="cpu")


def test_an_element_every_client_dropped_becomes_zero(tmp_path):
    """A leaf every selected client dropped is 0 in the new global (the
    reference's ``num / where(den == 0, 1, den)``), and the other leaves
    are what they are when nothing is dropped."""
    kwargs = {"dropout_rate": 0.3}
    rounds = {}
    for dropped in (0, -1):  # leaf 0; none
        session = _session(tmp_path, f"dropped{dropped}", "fed_dropout_avg", round=1, algorithm_kwargs=kwargs,
                           endpoint_kwargs={"worker": {"random": _FixedDraws(dropped)}})
        g = session._init_global_params()
        rounds[dropped] = session.run_round(g, session._base_weight_row(1), 1)
    leaf = session._jax_leaves[0]
    new, kept = rounds[0], rounds[-1]
    assert torch.all(new[leaf.start : leaf.stop] == 0.0)
    assert torch.any(kept[leaf.start : leaf.stop] != 0.0)
    assert torch.equal(new[: leaf.start], kept[: leaf.start]) and torch.equal(new[leaf.stop :], kept[leaf.stop :])


def test_an_unselected_slot_keeps_its_residual(tmp_path):
    """SMAFD with 2 of 4 clients a round: a slot outside a round's
    selection carries its residual unchanged; a selected one's becomes
    what it did not send (0 on the leaves it sent)."""
    kwargs = {"dropout_rate": 0.5, "random_client_number": 2}
    session = _session(tmp_path, "residual", "single_model_afd", algorithm_kwargs=kwargs)
    g = session._init_global_params()
    seen = set()
    for round_number in (1, 2, 3):
        before = session._err.clone()
        weights = session._base_weight_row(round_number)
        g = session.run_round(g, weights, round_number)
        for slot in range(WORKERS):
            if weights[slot] == 0:
                assert torch.equal(session._err[slot], before[slot]), (round_number, slot)
                continue
            seen.add(slot)
            keep = session.keep_leaves(round_number - 1, slot)
            assert 0 < keep.sum() < len(keep)
            for leaf, kept in zip(session._jax_leaves, keep):
                residual = session._err[slot, leaf.start : leaf.stop]
                assert bool(torch.all(residual == 0.0)) == bool(kept), (round_number, slot, leaf.key)
    assert len(seen) >= 3 and any(torch.any(session._err[s] != 0) for s in seen)


def _jax_budget_keep(sizes_np: np.ndarray, dropout_rate: float, order) -> np.ndarray:
    """The JAX session's whole-leaf dropout (``spmd_sparse.py:224-247``)."""
    sizes = jnp.asarray(sizes_np)
    threshold = np.float32((1.0 - dropout_rate) * np.sum(sizes_np, dtype=np.float32))

    def body(partial, i):
        size_i = sizes[order[i]]
        keep = partial + size_i <= threshold
        return partial + size_i * keep, keep

    _, keep_ord = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(len(sizes_np)))
    return np.asarray(jnp.zeros(len(sizes_np), bool).at[order].set(keep_ord))


def _f64_budget_keep(sizes: np.ndarray, dropout_rate: float, order) -> np.ndarray:
    threshold = (1.0 - dropout_rate) * float(np.sum(sizes, dtype=np.float64))
    keep, partial = np.zeros(len(sizes), bool), 0.0
    for i in order:
        if partial + float(sizes[i]) <= threshold:
            partial += float(sizes[i])
            keep[i] = True
    return keep


def test_budget_greedy_in_f32_picks_the_jax_leaves():
    """Leaf sizes past f32's exact integers (2^24), where f64 sums pick
    other leaves; and random sizes under many JAX permutations."""
    # past 2^24 an f32 sum of 1 rounds away: f32 keeps four leaves of 1, f64 two
    sizes = np.asarray([2.0**24, 1.0, 1.0, 1.0, 1.0, 2.0**24], np.float32)
    order = np.asarray([0, 1, 2, 3, 4, 5])
    want = _jax_budget_keep(sizes, 0.5, jnp.asarray(order))
    got = spmd_sparse.budget_keep(sizes, spmd_sparse.budget_threshold(sizes, 0.5), order)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(_f64_budget_keep(sizes, 0.5, order), want)  # the case f64 gets wrong
    rng = np.random.RandomState(0)
    for trial in range(20):
        sizes = rng.randint(1, 300_000, size=40).astype(np.float32)
        rate = float(rng.choice([0.1, 0.3, 0.5, 0.9]))
        order = jax.random.permutation(jax.random.PRNGKey(trial), len(sizes))
        want = _jax_budget_keep(sizes, rate, order)
        got = spmd_sparse.budget_keep(sizes, spmd_sparse.budget_threshold(sizes, rate), np.asarray(order))
        np.testing.assert_array_equal(got, want, err_msg=str(trial))


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_topk_upload_matches_jax(tmp_path, ratio):
    """One SMAFD upload with ``topk_ratio``: each leaf's sent elements are
    those of magnitude at least its k-th largest (``lax.top_k``; ties at
    the threshold admitted), the residual what was not sent."""
    session = _session(tmp_path, "topk", "single_model_afd", round=1, algorithm_kwargs={"topk_ratio": ratio})
    g = session._init_global_params()
    rng = np.random.RandomState(5)
    noise = torch.from_numpy((rng.randn(g.numel()) * 0.01).astype(np.float32))
    noise[:50] = 0.02  # ties inside the first leaf
    err = torch.from_numpy((rng.randn(g.numel()) * 0.001).astype(np.float32))
    session._err[1] = err
    row = torch.empty_like(g)
    session._upload(row, g + noise, g, g, 0, 1)
    delta = ((g + noise) - g) + err
    for leaf in session._jax_leaves:
        v = jnp.asarray(delta[leaf.start : leaf.stop].numpy())
        kth = max(1, int(v.size * ratio))
        thresh = jax.lax.top_k(jnp.abs(v), kth)[0][-1]
        sent = np.asarray(v * (jnp.abs(v) >= thresh).astype(jnp.float32))
        got_sent = (row[leaf.start : leaf.stop] - g[leaf.start : leaf.stop]).numpy()
        np.testing.assert_allclose(got_sent, sent, rtol=0, atol=1e-7, err_msg=leaf.key)
        assert np.array_equal(got_sent != 0, sent != 0), leaf.key
        np.testing.assert_array_equal(session._err[1, leaf.start : leaf.stop].numpy(), np.asarray(v) - sent)


def test_smafd_costs_and_k1_launches_follow_the_rounds(tmp_path, monkeypatch):
    """K1 runs once a chunk a round (``chip_smoke.expected_obd_k1``) for both
    sessions, FedDropoutAvg over ``[mb, 2·D]`` rows; an upload costs
    ``1 - dropout_rate`` (``topk_ratio`` with it) of the model."""
    import chip_smoke
    # both sessions run the FedAvg session's client loop, which calls K1
    from distributed_learning_simulator_tpu_torch.parallel import spmd as module

    calls = []
    aggregate = module.flat_stack_weighted_sum

    def counted(rows, w):
        calls.append(tuple(rows.shape))
        return aggregate(rows, w)

    monkeypatch.setattr(module, "flat_stack_weighted_sum", counted)
    for algorithm, kwargs, factor in (
        ("fed_dropout_avg", {"dropout_rate": 0.3}, 0.7),
        ("single_model_afd", {"dropout_rate": 0.3}, 0.7),
        ("single_model_afd", {"topk_ratio": 0.2}, 0.2),
    ):
        calls.clear()
        config = tconfig.DistributedTrainingConfig(
            **_fields(tmp_path, algorithm, algorithm, epoch=1, algorithm_kwargs={**kwargs, "client_chunk": 2})
        )
        session = training.build_session(config, device="cpu")
        perf = session.run()["performance"]
        size = session.engine.layout.size
        width = 2 * size if algorithm == "fed_dropout_avg" else size
        assert calls == [(2, width)] * chip_smoke.expected_obd_k1(ROUNDS, WORKERS, 2)
        full = size * 4 / 1e6 * WORKERS
        for row in perf.values():
            assert row["sent_mb"] == pytest.approx(full) and row["received_mb"] == pytest.approx(full * factor)


# ---------------------------------------------------------------- shipped files
@pytest.mark.parametrize("name", ["fed_dropout_avg/imdb.yaml", "smafd/imdb.yaml"])
def test_shipped_file_matches_jax(tmp_path, monkeypatch, name):
    """The file through both packages' ``load_config`` (the classifier at
    full width, max_len 300), cut to 2 rounds of 1 epoch, batch 4 and
    small datasets, from one JAX init, ``EncoderLayer`` dropout 0 in both,
    the port fed the JAX draws."""
    _no_text_dropout(monkeypatch)
    monkeypatch.chdir(tmp_path)  # session/ and log/ land here
    overrides = ["++round=2", "++epoch=1", "++batch_size=4", "++dataset_kwargs.train_size=40",
                 "++dataset_kwargs.val_size=8", "++dataset_kwargs.test_size=16"]
    shipped = jconfig.load_config(["--config-name", name, *overrides])
    ctx = j_create_model(shipped.model_name, j_create_dc(shipped), **shipped.model_kwargs)
    init = str(tmp_path / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0).items()})
    overrides.append(f"++algorithm_kwargs.global_model_path={init}")
    jc = jconfig.load_config(["--config-name", name, *overrides, f"++save_dir={tmp_path / 'jax'}"])
    tc = tconfig.load_config(["--config-name", name, *overrides, f"++save_dir={tmp_path / 'torch'}"])
    assert tc.model_kwargs["max_len"] == 300 and tc.model_kwargs["d_model"] == 100
    tc.endpoint_kwargs.setdefault("worker", {})["random"] = JaxSparseRandom(jc.seed, jc.worker_number)
    jres = jax_train(jc)["performance"]
    tres = training.train(tc, device="cpu")["performance"]
    _assert_match(jc, tc, jres, tres)
