"""The port's graph sessions (``parallel/spmd_gnn.py``) against the JAX
package's ``SpmdFedGNNSession`` / ``SpmdFedAASSession``.

Both packages start from the JAX init (through the weight bridge), and
the port draws the JAX session's uniforms: :class:`JaxGraphRandom` returns,
for each (round, epoch, batch), every slot's ``jax.random.uniform`` from
the keys the JAX round program folds (``split(split(PRNGKey(seed))[round],
S)[slot]``, ``split(., epochs)``, then ``fold_in(., 7)`` for the
assignment and ``fold_in(fold_in(., 11), b)`` for the fan-in priorities).
The models' dropout is 0 in both packages (flax's threefry bits cannot be
reproduced).  Each case runs 2 rounds of 2 epochs on a 512-node,
16-feature graph: the records within ``RECORD_RTOL``, ``received_mb`` /
``sent_mb`` exact, and every round's ``aggregated_model/round_N.npz``
within ``PARAM_RTOL`` of JAX's (relative to each leaf's largest value;
the scatter-adds sum in other orders).  Also: one K1 launch a round, both
npz artifacts, R13's training-node count, the schedule's ``total_steps``
from the training mask's count, a slot whose batch is empty still
stepping, and the refusals.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu import training as jtraining
from distributed_learning_simulator_tpu.models import graph as jgraph
from distributed_learning_simulator_tpu.parallel.mesh import client_slots, make_mesh
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.ml_type import MachineLearningPhase as Phase
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.models import graph as tgraph
from distributed_learning_simulator_tpu_torch.ops.graph_sampling import GraphRandom
from distributed_learning_simulator_tpu_torch.parallel import spmd_gnn

#: records (test loss) and per-round parameters, relative; measured on the
#: CPU: see PERF.md (the worst case over the cases below)
RECORD_RTOL = 1e-4
PARAM_RTOL = 1e-4

SMALL = {"num_nodes_": 512, "num_features_": 16}
CASES = {
    "fed_gnn": dict(distributed_algorithm="fed_gnn", model_name="TwoGCN", dataset_name="Coauthor_CS",
                    worker_number=4,
                    algorithm_kwargs={"share_feature": True, "edge_drop_rate": 0.5, "batch_number": 2,
                                      "num_neighbor": 3}),
    "fed_gcn": dict(distributed_algorithm="fed_gcn", model_name="TwoGCN", dataset_name="Cora", worker_number=6,
                    algorithm_kwargs={"share_feature": False, "edge_drop_rate": 0.3}),
    "fed_aas": dict(distributed_algorithm="fed_aas", model_name="SimpleGCN", dataset_name="Reddit", worker_number=5,
                    weight_decay=0.01, algorithm_kwargs={"share_feature": False, "batch_number": 2,
                                                         "edge_drop_rate": 0.99},
                    extra_hyper_parameters={"num_neighbor": 3}),
    "three_gcn": dict(distributed_algorithm="fed_gnn", model_name="ThreeGCN", dataset_name="PubMed", worker_number=4,
                      algorithm_kwargs={"share_feature": True, "edge_drop_rate": 0.2}),
}


class JaxGraphRandom(GraphRandom):
    """The JAX GNN session's uniforms for the port's requests."""

    def __init__(self, seed: int, jax_slots: int, n_slots: int, epochs: int) -> None:
        self.seed, self.jax_slots, self.n_slots, self.epochs = seed, jax_slots, n_slots, epochs

    def _epoch_keys(self, round_number: int, epoch: int) -> list:
        rng = jax.random.PRNGKey(self.seed)
        for _ in range(round_number):
            rng, round_rng = jax.random.split(rng)
        clients = jax.random.split(round_rng, self.jax_slots)
        return [jax.random.split(clients[s], self.epochs)[epoch] for s in range(self.n_slots)]

    def assignment_uniform(self, seed, round_number, epoch, shape, device):
        keys = self._epoch_keys(round_number, epoch)
        draws = [np.asarray(jax.random.uniform(jax.random.fold_in(k, 7), shape[1:])) for k in keys]
        return torch.from_numpy(np.stack(draws)).to(device)

    def priority_uniform(self, seed, round_number, epoch, batch, shape, device):
        keys = self._epoch_keys(round_number, epoch)
        draws = [
            np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.fold_in(k, 11), batch), shape[1:]))
            for k in keys
        ]
        return torch.from_numpy(np.stack(draws)).to(device)


@pytest.fixture()
def no_dropout(monkeypatch):
    """TwoGCN's and ThreeGCN's dropout at 0 in both packages, in this test."""
    for name in ("TwoGCN", "ThreeGCN"):
        jcls, tcls = getattr(jgraph, name), getattr(tgraph, name)
        jsub = type(name, (jcls,), {"__annotations__": {"dropout_rate": float}, "dropout_rate": 0.0})

        def init(self, *args, _base=tcls, **kwargs):
            _base.__init__(self, *args, **kwargs)
            self.dropout_rate = 0.0

        monkeypatch.setattr(jgraph, name, jsub)
        monkeypatch.setattr(tgraph, name, type(name, (tcls,), {"__init__": init}))


def _configs(tmp_path, case: str, **extra):
    fields = dict(CASES[case], round=2, epoch=2, learning_rate=0.1, dataset_kwargs=dict(SMALL))
    fields.update(extra)
    jc = jconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "jax"), log_file=str(tmp_path / "j.log"))
    tc = tconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "torch"), log_file=str(tmp_path / "t.log"))
    jc.load_config_and_process()
    tc.load_config_and_process()
    tc.endpoint_kwargs = {
        "worker": {"random": JaxGraphRandom(tc.seed, client_slots(tc.worker_number, make_mesh()), tc.worker_number,
                                            tc.epoch)}
    }
    return jc, tc


def _jax_init(jc) -> dict:
    from distributed_learning_simulator_tpu.data import create_dataset_collection
    from distributed_learning_simulator_tpu.models.registry import create_model_context

    ctx = create_model_context(jc.model_name, create_dataset_collection(jc))
    return {k: np.asarray(v) for k, v in ctx.init(jax.random.PRNGKey(jc.seed)).items()}


def _port_session(tc, init: dict):
    session = training.build_session(tc, device="cpu")
    session.engine.init_params = lambda seed: convert.from_jax(init)
    return session


def _round_params(config, round_number: int) -> dict:
    with np.load(os.path.join(config.save_dir, "aggregated_model", f"round_{round_number}.npz")) as blob:
        return {k: blob[k] for k in blob.files}


@pytest.mark.usefixtures("no_dropout")
@pytest.mark.parametrize("case", list(CASES))
def test_session_matches_jax(tmp_path, case):
    jc, tc = _configs(tmp_path, case)
    session = _port_session(tc, _jax_init(jc))
    tres = session.run()["performance"]
    jres = jax_train(jc)["performance"]
    assert sorted(tres) == sorted(jres) == [1, 2]
    worst_record = worst_param = 0.0
    for r, want in jres.items():
        got = tres[r]
        assert set(got) - set(want) == {"round_seconds"} and set(want) <= set(got)
        assert got["received_mb"] == want["received_mb"] and got["sent_mb"] == want["sent_mb"]
        assert got["test_count"] == want["test_count"]
        assert abs(got["test_accuracy"] - want["test_accuracy"]) <= 1 / want["test_count"]
        worst_record = max(worst_record, abs(got["test_loss"] - want["test_loss"]) / abs(want["test_loss"]))
        jp, tp = _round_params(jc, r), _round_params(tc, r)
        assert sorted(tp) == sorted(jp)
        for key, value in jp.items():
            worst_param = max(worst_param, float(np.abs(tp[key] - value).max() / np.abs(value).max()))
    print(f"  {case}: records {worst_record:.3g}, parameters {worst_param:.3g} apart (relative)")
    assert worst_record <= RECORD_RTOL and worst_param <= PARAM_RTOL
    if case in ("fed_gnn", "three_gcn"):
        assert tres[1]["received_mb"] > 0
    with open(os.path.join(tc.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        assert sorted(json.load(f)) == ["1", "2"]


def test_k1_once_a_round_and_artifacts(tmp_path, monkeypatch):
    jc, tc = _configs(tmp_path, "fed_aas", round=3, epoch=1)
    session = _port_session(tc, _jax_init(jc))
    calls = []
    aggregate = spmd_gnn.flat_stack_weighted_sum

    def counted(rows, weights):
        calls.append((tuple(rows.shape), rows.stride(0), weights.clone()))
        return aggregate(rows, weights)

    monkeypatch.setattr(spmd_gnn, "flat_stack_weighted_sum", counted)
    perf = session.run()["performance"]
    assert len(calls) == 3
    d = session.engine.layout.size
    for shape, stride, weights in calls:
        assert shape == (5, d) and stride % 64 == 0 and stride >= d
        assert np.array_equal(weights.numpy(), session._dataset_sizes)
    for r in (1, 2, 3):
        params = _round_params(tc, r)
        assert sorted(params) == sorted(_jax_init(jc))
    best = max(perf, key=lambda r: (perf[r]["test_accuracy"], -r))
    with np.load(os.path.join(tc.save_dir, "server", "best_global_model.npz")) as blob:
        saved = {k: blob[k] for k in blob.files}
    want = _round_params(tc, best)
    assert all(np.array_equal(saved[k], want[k]) for k in want)


def test_r13_every_owned_node_trains(tmp_path):
    """``conf/fed_aas/cora.yaml``: the 10 workers own all 2048 nodes and
    train on all of them (the JAX session's behaviour, R13), while the
    graph has 1228 training nodes."""
    config = tconfig.load_config(["--config-name", "fed_aas/cora.yaml", f"++save_dir={tmp_path}"])
    session = training.build_session(config, device="cpu")
    assert int(session._masks["train_mask"].sum()) == 2048
    assert float(session._dataset_sizes.sum()) == 2048.0
    from distributed_learning_simulator_tpu_torch.data import create_dataset_collection

    assert create_dataset_collection(config).dataset_size(Phase.Training) == 1228
    jc = jconfig.load_config(["--config-name", "fed_aas/cora.yaml", f"++save_dir={tmp_path}/jax"])
    jsession = jtraining._make_spmd_session(jtraining._build_task(jc))
    assert float(np.asarray(jsession._data["train_mask"]).sum()) == 2048.0


def test_total_steps_follow_the_training_mask():
    """``conf/fed_gnn/cs.yaml``: ``ceil(2457 / 50 / 64) * 1`` = 1 step, as in
    the JAX package: the periodic cosine alternates ``lr`` and 0."""
    config = tconfig.load_config(["--config-name", "fed_gnn/cs.yaml"])
    prepared = training._prepare(config, None, "cpu")
    train_size = prepared.dataset_collection.dataset_size(Phase.Training)
    assert train_size == 2457 and train_size != 4096
    assert prepared.engine.total_steps == math.ceil(2457 / 50 / 64) * 1 == 1
    jc = jconfig.load_config(["--config-name", "fed_gnn/cs.yaml"])
    assert jtraining._build_task(jc).engine.total_steps == 1
    schedule = prepared.engine.optimizer.schedule
    assert [float(schedule(i)) for i in range(3)] == [pytest.approx(0.001), 0.0, pytest.approx(0.001)]


@pytest.mark.usefixtures("no_dropout")
def test_slot_with_an_empty_batch_still_steps(tmp_path):
    """A slot whose batch holds no training node takes its step all the
    same: momentum and weight decay move it, and the count advances."""
    _, tc = _configs(tmp_path, "fed_gcn", weight_decay=0.01)
    session = training.build_session(tc, device="cpu")
    g = session.engine.layout.flatten(session.engine.init_params(0))
    params = g.expand(session.n_slots, -1).clone()
    opt = session.engine.init_opt_state(params)
    m = session._masks
    session.train_step(params, opt, m["local_edges"], m["cross_edges"], m["train_mask"], None)
    after_one = params.clone()
    empty = m["train_mask"].clone()
    empty[0] = 0.0
    trace = opt.trace[0].clone()
    session.train_step(params, opt, m["local_edges"], m["cross_edges"], empty, None)
    assert opt.count == 2
    # slot 0's gradient is 0: trace = wd * p + momentum * trace, p -= lr(1) * trace
    lr = float(session.engine.optimizer.schedule(1))
    want_trace = after_one[0] * 0.01 + 0.9 * trace
    assert torch.allclose(opt.trace[0], want_trace, rtol=1e-6, atol=1e-7)
    assert torch.allclose(params[0], after_one[0] - lr * want_trace, rtol=1e-6, atol=1e-7)
    assert not torch.equal(params[0], after_one[0])


@pytest.mark.parametrize(
    "kwargs, error, words",
    [
        ({"client_chunk": 2}, NotImplementedError, "client_chunk"),
        ({"random_client_number": 2}, NotImplementedError, "Queue 1 item 7"),
        # resume_dir runs (tests/test_torch_resume.py); a horizon is still refused
        ({"round_horizon": 2}, NotImplementedError, "round_horizon"),
    ],
)
def test_refusals(tmp_path, kwargs, error, words):
    _, tc = _configs(tmp_path, "fed_gnn")
    tc.algorithm_kwargs.update(kwargs)
    with pytest.raises(error, match=words):
        training.build_session(tc, device="cpu")


def test_a_codec_random_source_is_refused(tmp_path):
    from distributed_learning_simulator_tpu_torch.ops.quantization import CodecRandom

    _, tc = _configs(tmp_path, "fed_aas")
    tc.endpoint_kwargs = {"worker": {"random": CodecRandom()}}
    with pytest.raises(TypeError, match="GraphRandom"):
        training.build_session(tc, device="cpu")


def test_fed_gcn_forces_share_feature_and_fed_aas_never_shares(tmp_path):
    _, tc = _configs(tmp_path, "fed_gcn")
    assert tc.algorithm_kwargs["share_feature"] is False
    assert training.build_session(tc, device="cpu").share_feature
    _, tc = _configs(tmp_path, "fed_aas", algorithm_kwargs={"share_feature": True})
    session = training.build_session(tc, device="cpu")
    assert not session.share_feature and session._round_payload_bytes == 0
