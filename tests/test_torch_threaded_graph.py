"""The port's threaded graph FL (``executor: sequential``: ``fed_gnn``,
``fed_gcn``, ``fed_aas``; ``worker/graph_worker.py``,
``algorithm/graph_algorithm.py``) against the JAX package's threaded run,
from one JAX init through the weight bridge, on a 512-node, 16-feature
graph, 2 rounds of 2 epochs, the models' dropout 0 in both packages:

* fed_gnn with ``share_feature``, ``batch_number`` 2 and ``num_neighbor`` 4
  (the data loader's minibatches and fan-in caps from the same numpy
  streams); fed_gcn (``share_feature`` forced on); fed_aas with a
  per-round ``num_neighbor``; ThreeGCN, whose steps make
  ``num_mp_layers - 1`` exchanges;
* every record within ``RECORD_RTOL`` (``received_mb`` / ``sent_mb``
  equal), every ``aggregated_model/round_N.npz`` within ``PARAM_RTOL`` of
  the JAX one (relative to each leaf's largest value; the scatter-adds sum
  in other orders), every ``graph_worker_stat.json`` equal, and K1
  launched 0 times (the threaded FedAvg streams its uploads); the
  telemetry records the JAX server writes (an upload event a message, a
  barrier an aggregate, the exchanges' included);
* ``make_graph_minibatches``' masks bit-equal to the JAX package's;
* a worker with no training node fails both packages' FedAvg (R17).
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine import batching as jbatching
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training
from distributed_learning_simulator_tpu_torch.data import create_dataset_collection as t_create_dc
from distributed_learning_simulator_tpu_torch.engine import batching as tbatching
from distributed_learning_simulator_tpu_torch.ml_type import MachineLearningPhase as Phase
from distributed_learning_simulator_tpu_torch.ops import pytree
from tools.tracedump import load_trace
from test_torch_gnn_session import no_dropout  # noqa: F401  (fixture)

#: records (test loss) and per-round parameters, relative, as the graph
#: sessions' test holds them
RECORD_RTOL = 1e-4
PARAM_RTOL = 1e-4

SMALL = {"num_nodes_": 512, "num_features_": 16}
CASES = {
    "fed_gnn": dict(distributed_algorithm="fed_gnn", model_name="TwoGCN", dataset_name="Coauthor_CS",
                    algorithm_kwargs={"share_feature": True, "edge_drop_rate": 0.5, "batch_number": 2,
                                      "num_neighbor": 4}),
    "fed_gcn": dict(distributed_algorithm="fed_gcn", model_name="TwoGCN", dataset_name="Cora",
                    algorithm_kwargs={"share_feature": False, "edge_drop_rate": 0.3}),
    "fed_aas": dict(distributed_algorithm="fed_aas", model_name="SimpleGCN", dataset_name="Reddit",
                    weight_decay=0.01, algorithm_kwargs={"share_feature": False, "batch_number": 2,
                                                         "edge_drop_rate": 0.99, "num_neighbor": 3}),
    "three_gcn": dict(distributed_algorithm="fed_gnn", model_name="ThreeGCN", dataset_name="PubMed",
                      algorithm_kwargs={"share_feature": True, "edge_drop_rate": 0.2}),
}


def _configs(tmp_path, case: str):
    fields = dict(CASES[case], executor="sequential", worker_number=4, round=2, epoch=2, learning_rate=0.1,
                  dataset_kwargs=dict(SMALL), telemetry={"enabled": True})
    jc = jconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "jax"), log_file=str(tmp_path / "j.log"))
    ctx = j_create_model(jc.model_name, j_create_dc(jc))
    init = str(tmp_path / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in ctx.init(jax.random.PRNGKey(jc.seed)).items()})
    jc.algorithm_kwargs = dict(jc.algorithm_kwargs, global_model_path=init)
    tc = tconfig.DistributedTrainingConfig(**{**fields, "algorithm_kwargs": dict(jc.algorithm_kwargs)},
                                           save_dir=str(tmp_path / "torch"), log_file=str(tmp_path / "t.log"))
    jc.load_config_and_process()
    tc.load_config_and_process()
    return jc, tc


def _trace_kinds(config) -> list[tuple]:
    """The trace's records as (record, kind, round), the JAX package's
    one-sided ``compile`` and ``program_cost`` left out."""
    records = load_trace(os.path.join(config.save_dir, "server", "trace.jsonl"))
    return [(r["ev"], r["kind"], r.get("round")) for r in records if r["kind"] not in ("compile", "program_cost")]


def _records(config) -> dict:
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        return json.load(f)


def _round_params(config, round_number: int) -> dict:
    with np.load(os.path.join(config.save_dir, "aggregated_model", f"round_{round_number}.npz")) as blob:
        return {k: blob[k] for k in blob.files}


def _worker_stats(config) -> dict:
    stats = {}
    for path in glob.glob(os.path.join(config.save_dir, "worker_*", "graph_worker_stat.json")):
        with open(path, encoding="utf8") as f:
            stats[os.path.basename(os.path.dirname(path))] = json.load(f)
    return stats


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("no_dropout")
@pytest.mark.parametrize("case", sorted(CASES))
def test_threaded_matches_jax_threaded(tmp_path, monkeypatch, case):
    jc, tc = _configs(tmp_path, case)
    jres = jax_train(jc)["performance"]
    calls = []
    accum = pytree.weighted_accum
    monkeypatch.setattr(pytree, "weighted_accum", lambda x, w: calls.append(x.shape) or accum(x, w))
    tres = training.train(tc, device="cpu")["performance"]
    assert not calls  # no K1: the threaded FedAvg accumulates as uploads arrive
    assert sorted(tres) == sorted(jres) == [1, 2]
    jrec, trec = _records(jc), _records(tc)
    assert sorted(trec) == sorted(jrec) == ["1", "2"]
    for key, want in jrec.items():
        got = trec[key]
        assert set(want) <= set(got), key
        np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=RECORD_RTOL, err_msg=key)
        assert got["test_accuracy"] == want["test_accuracy"], key
        assert (got["received_mb"], got["sent_mb"]) == (want["received_mb"], want["sent_mb"]), key
    assert _trace_kinds(tc) == _trace_kinds(jc)  # an upload event and a barrier a message, as JAX's
    worst = 0.0
    for r in (1, 2):
        want, got = _round_params(jc, r), _round_params(tc, r)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            rel = float(np.abs(got[key] - value).max() / max(np.abs(value).max(), 1e-30))
            worst = max(worst, rel)
            assert rel <= PARAM_RTOL, (r, key, rel)
    jstats, tstats = _worker_stats(jc), _worker_stats(tc)
    assert sorted(tstats) == sorted(jstats) == [f"worker_{w}" for w in range(tc.worker_number)]
    assert tstats == jstats
    share = {"fed_gcn": True, "fed_aas": False}.get(tc.distributed_algorithm, tc.algorithm_kwargs["share_feature"])
    boundaries = 2 if tc.model_name == "ThreeGCN" else 1
    batches = int(tc.algorithm_kwargs.get("batch_number") or 1)
    exchanges = tc.round * tc.epoch * batches * boundaries if share else 0
    assert all(stat["exchange_count"] == exchanges for stat in tstats.values()), tstats
    print(f"{case}: parameters {worst:.3g} apart (relative, both rounds); records {trec}")


def test_make_graph_minibatches_masks_bit_equal():
    """The data loader's minibatch masks and fan-in caps from one seed."""
    fields = dict(dataset_name="Coauthor_CS", dataset_kwargs=dict(SMALL))
    tds = t_create_dc(tconfig.DistributedTrainingConfig(**fields)).get_dataset(Phase.Training)
    jds = j_create_dc(jconfig.DistributedTrainingConfig(**fields)).get_dataset(jbatching.Phase.Training)
    for num_neighbor in (None, 3):
        want = jbatching.make_graph_minibatches(
            jbatching.make_graph_batch(jds), 3, num_neighbor, np.random.default_rng(100003 * 2 + 1)
        )
        got = tbatching.make_graph_minibatches(
            tbatching.make_graph_batch(tds), 3, num_neighbor, np.random.default_rng(100003 * 2 + 1)
        )
        assert np.asarray(got["mask"]).tobytes() == np.asarray(want["mask"]).tobytes()
        assert sorted(got["input"]) == sorted(want["input"])
        for key, value in want["input"].items():
            assert np.asarray(got["input"][key]).tobytes() == np.asarray(value).tobytes(), key
        assert np.asarray(got["target"]).tobytes() == np.asarray(want["target"]).tobytes()


def test_a_worker_without_training_nodes_fails_as_jax(tmp_path):
    """ROADMAP R17: 50 workers on a 512-node graph leave a worker no
    training node, whose upload weighs 0, which the FedAvg of both packages'
    threaded servers refuses (``dataset_size != 0``)."""
    fields = dict(distributed_algorithm="fed_aas", model_name="SimpleGCN", dataset_name="Coauthor_CS",
                  executor="sequential", worker_number=50, round=1, epoch=1, dataset_kwargs=dict(SMALL),
                  algorithm_kwargs={"share_feature": False})
    with pytest.raises(AssertionError):
        jax_train(jconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "jax")))
    with pytest.raises(AssertionError):
        training.train(tconfig.DistributedTrainingConfig(**fields, save_dir=str(tmp_path / "torch")), device="cpu")
