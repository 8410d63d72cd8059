"""The port's graph data, sampling and models against the JAX package's.

* The synthetic graphs of all ten registered names (at 256 nodes and 16
  features where the factory takes a size; CitationFull's is fixed) are
  byte-equal, and ``Yelp`` raises the same ``KeyError`` in both packages.
* The graph sampler's node partition, ``__len__`` and ``subset`` equal
  JAX's.
* ``cap_fan_in`` is exact; ``cap_fan_in_torch`` and
  ``minibatch_assignment`` fed the uniforms ``jax.random.uniform`` draws
  from the JAX functions' keys return the JAX functions' masks and batch
  ids exactly, one slot at a time and ``[S, ...]`` at once.
* TwoGCN, ThreeGCN, SimpleGCN and OneGCN match flax ``apply`` on the
  bridged parameters with and without an edge mask (rel ``MODEL_RTOL``);
  the stage API equals ``forward``; the slot-batched forward equals the
  per-slot forwards; the bridge round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.data import collection as jcollection
from distributed_learning_simulator_tpu.data.registry import global_dataset_factory as jax_datasets
from distributed_learning_simulator_tpu.ml_type import MachineLearningPhase as JPhase
from distributed_learning_simulator_tpu.models.registry import create_model_context as jax_model
from distributed_learning_simulator_tpu.ops import graph_sampling as jgs
from distributed_learning_simulator_tpu.sampler.base import get_dataset_collection_sampler as jax_sampler
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.data import collection as tcollection
from distributed_learning_simulator_tpu_torch.data.registry import global_dataset_factory as torch_datasets
from distributed_learning_simulator_tpu_torch.ml_type import MachineLearningPhase as Phase
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.models.registry import create_model_context as torch_model
from distributed_learning_simulator_tpu_torch.ops import graph_sampling as tgs
from distributed_learning_simulator_tpu_torch.sampler import get_dataset_collection_sampler as torch_sampler

#: the JAX registry's graph names: nine sized factories and CitationFull
SIZED = ["Cora", "PubMed", "Coauthor_CS", "dblp", "reddit", "Reddit", "yelp", "AmazonProduct", "amazonproduct"]
SMALL = {"num_nodes_": 256, "num_features_": 16}
#: the GCNs against flax on the same parameters: the same f32 products and
#: sums in other orders (index_add_ against segment_sum)
MODEL_RTOL = 1e-5
MODELS = ["TwoGCN", "ThreeGCN", "SimpleGCN", "OneGCN"]


def _collections(name: str):
    kwargs = SMALL if name in SIZED else {"name": "DBLP"}
    return jax_datasets[name](**kwargs), torch_datasets[name](**kwargs)


@pytest.mark.parametrize("name", SIZED + ["CitationFull"])
def test_synthetic_graph_is_byte_equal(name):
    jdc, tdc = _collections(name)
    assert tdc.dataset_type == jdc.dataset_type == "graph"
    assert (tdc.name, tdc.num_classes, tdc.input_shape, tdc.metadata) == (
        jdc.name, jdc.num_classes, jdc.input_shape, jdc.metadata,
    )
    assert sorted(tdc.datasets, key=str) == sorted(jdc.datasets, key=str)
    for phase, jset in jdc.datasets.items():
        tset = tdc.datasets[Phase(phase.value)]
        assert sorted(tset.inputs) == sorted(jset.inputs) == ["edge_index", "mask", "x"]
        for key, value in jset.inputs.items():
            assert tset.inputs[key].dtype == value.dtype and np.array_equal(tset.inputs[key], value), key
        assert tset.targets.dtype == jset.targets.dtype and np.array_equal(tset.targets, jset.targets)
        assert len(tset) == len(jset) == int(jset.inputs["mask"].sum())


def test_yelp_raises_the_jax_key_error():
    errors = []
    for module, cfg in ((jcollection, jconfig), (tcollection, tconfig)):
        config = cfg.DistributedTrainingConfig(dataset_name="Yelp")
        with pytest.raises(KeyError) as info:
            module.create_dataset_collection(config)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "unknown dataset 'Yelp'" in errors[0]


@pytest.mark.parametrize("parts", [4, 6])
def test_graph_partition_len_and_subset_match_jax(parts):
    jdc, tdc = _collections("Cora")
    jsampler = jax_sampler("iid", jdc, parts, seed=3)
    tsampler = torch_sampler("iid", tdc, parts, seed=3)
    for part in range(parts):
        jparts, tparts = jsampler.sample(part), tsampler.sample(part)
        assert sorted(tparts, key=str) == sorted(jparts, key=str)
        for phase, idx in jparts.items():
            tidx = tparts[Phase(phase.value)]
            assert np.array_equal(tidx, idx), (part, phase)
            jsub = jdc.get_dataset(phase).subset(idx)
            tsub = tdc.get_dataset(Phase(phase.value)).subset(tidx)
            assert len(tsub) == len(jsub)
            assert np.array_equal(tsub.inputs["mask"], jsub.inputs["mask"])
            assert tsub.inputs["x"] is tdc.get_dataset(Phase(phase.value)).inputs["x"]  # global shapes kept
    # the split covers every node once, shared by the phases
    owned = np.concatenate([tsampler.sample(p)[Phase.Training] for p in range(parts)])
    assert np.array_equal(np.sort(owned), np.arange(len(tdc.get_dataset(Phase.Training).targets)))
    assert np.array_equal(tsampler.sample(0)[Phase.Test], tsampler.sample(0)[Phase.Training])


def _edges(seed: int, n_nodes: int = 64, n_edges: int = 600):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    mask = rng.random(n_edges) < 0.7
    return mask, dst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cap_fan_in_is_exact(seed):
    mask, dst = _edges(seed)
    for limit in (1, 3, 10, 1000):
        want = jgs.cap_fan_in(mask, dst, limit, np.random.default_rng(seed + 100))
        got = tgs.cap_fan_in(mask, dst, limit, np.random.default_rng(seed + 100))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not tgs.cap_fan_in(np.zeros_like(mask), dst, 3, np.random.default_rng(0)).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cap_fan_in_torch_from_jax_uniforms_is_exact(seed):
    """The JAX function's mask from its key; the port's from that key's
    uniforms, per slot and with a slot axis; ties in the priorities (a
    quarter of the uniforms repeated) are broken as JAX's stable sort
    breaks them."""
    slots = [_edges(seed * 10 + s) for s in range(4)]
    dst = slots[0][1]
    masks = np.stack([m for m, _ in slots]).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    for limit in (1, 3, 10):
        want = np.stack([np.asarray(jgs.cap_fan_in_jax(jnp.asarray(m), jnp.asarray(dst), limit, k))
                         for m, k in zip(masks, keys)])
        priority = np.stack([np.asarray(jax.random.uniform(k, (dst.shape[0],))) for k in keys])
        tdst = torch.from_numpy(dst.astype(np.int64))
        got = tgs.cap_fan_in_torch(torch.from_numpy(masks), tdst, limit, torch.from_numpy(priority))
        assert np.array_equal(got.numpy(), want)
        for s in range(4):
            one = tgs.cap_fan_in_torch(torch.from_numpy(masks[s]), tdst, limit, torch.from_numpy(priority[s]))
            assert np.array_equal(one.numpy(), want[s])
    # tied priorities: the JAX lexsort's order, through the JAX sort itself
    tied = np.array(jax.random.uniform(keys[0], (dst.shape[0],)))
    tied[::4] = tied[1::4][: len(tied[::4])]
    for limit in (1, 2):
        active = masks[0] > 0
        pri = np.where(active, tied, 2.0)
        order = np.asarray(jnp.lexsort((jnp.asarray(pri), jnp.asarray(dst))))
        sorted_dst = dst[order]
        rank = np.arange(len(dst)) - np.searchsorted(sorted_dst, sorted_dst, side="left")
        want = np.zeros(len(dst), np.float32)
        want[order] = (rank < limit) & (pri[order] < 1.5)
        got = tgs.cap_fan_in_torch(torch.from_numpy(masks[0]), torch.from_numpy(dst.astype(np.int64)), limit,
                                   torch.from_numpy(tied))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("batch_number", [1, 2, 10])
def test_minibatch_assignment_from_jax_uniforms_is_exact(batch_number):
    rng = np.random.default_rng(batch_number)
    train = (rng.random((4, 300)) < 0.4).astype(np.float32)
    train[3] = 0.0  # a slot with no training node
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    want = np.stack([np.asarray(jgs.minibatch_assignment(jnp.asarray(t), batch_number, k)) for t, k in zip(train, keys)])
    uniform = np.stack([np.asarray(jax.random.uniform(k, (300,))) for k in keys])
    got = tgs.minibatch_assignment(torch.from_numpy(train), batch_number, torch.from_numpy(uniform))
    assert np.array_equal(got.numpy(), want)
    counts = [np.bincount(got[s].numpy()[train[s] > 0], minlength=batch_number) for s in range(3)]
    assert all(c.max() - c.min() <= 1 for c in counts)


def _model_pair(name: str):
    jdc, tdc = _collections("Cora")
    jctx = jax_model(name, jdc)
    tctx = torch_model(name, tdc, torch.device("cpu"))
    params = {k: np.asarray(v) for k, v in jctx.init(jax.random.PRNGKey(1)).items()}
    graph = {k: v for k, v in jdc.get_dataset(JPhase.Training).inputs.items() if k != "mask"}
    return jctx, tctx, params, graph


def _torch_inputs(graph, edge_mask=None):
    inputs = {"x": torch.from_numpy(graph["x"]), "edge_index": torch.from_numpy(graph["edge_index"].astype(np.int64))}
    if edge_mask is not None:
        inputs["edge_mask"] = torch.from_numpy(edge_mask)
    return inputs


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "edge_mask"])
def test_gcn_matches_flax_apply(name, masked):
    jctx, tctx, params, graph = _model_pair(name)
    n_edges = graph["edge_index"].shape[1]
    edge_mask = (np.random.default_rng(5).random(n_edges) < 0.5).astype(np.float32) if masked else None
    jinputs = dict(graph, **({"edge_mask": edge_mask} if masked else {}))
    want = np.asarray(jctx.apply(params, jinputs, train=False))
    state = convert.from_jax(params)
    assert sorted(state) == sorted(tctx.module.state_dict())
    with torch.no_grad():
        got = tctx.apply(state, _torch_inputs(graph, edge_mask))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= MODEL_RTOL
    # the stage API chained equals forward
    module = tctx.module
    inputs = _torch_inputs(graph, edge_mask)
    with torch.no_grad():
        h = torch.func.functional_call(module, state, (inputs,), {"stage": 0})
        for i in range(1, module.num_mp_layers):
            h = torch.func.functional_call(module, state, (inputs,), {"stage": i, "h": h})
    assert torch.equal(h, got)


@pytest.mark.parametrize("name", MODELS)
def test_slot_batched_forward_equals_per_slot(name):
    """``[S, ...]`` parameters and ``[S, E]`` edge masks in one call give
    each slot's own forward (dropout on, its uniforms from one draw)."""
    _, tctx, params, graph = _model_pair(name)
    module = tctx.module
    S = 3
    rng = np.random.default_rng(2)
    states = []
    for s in range(S):
        state = convert.from_jax(params)
        states.append({k: v + 0.01 * s * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
                       for k, v in state.items()})
    stacked = {k: torch.stack([st[k] for st in states]) for k in states[0]}
    masks = (rng.random((S, graph["edge_index"].shape[1])) < 0.6).astype(np.float32)
    uniforms = {}

    def draw(stage, shape):
        if stage not in uniforms:
            uniforms[stage] = torch.from_numpy(rng.random(shape).astype(np.float32))
        return uniforms[stage]

    module.train(True)
    together = torch.func.functional_call(module, stacked, (_torch_inputs(graph, masks),), {"draw": draw})
    for s in range(S):
        alone = torch.func.functional_call(
            module, states[s], (_torch_inputs(graph, masks[s]),), {"draw": lambda stage, shape: uniforms[stage][s]}
        )
        assert torch.allclose(together[s], alone, rtol=1e-6, atol=1e-6)
    module.train(False)
    assert len(uniforms) == (module.num_mp_layers - 1 if name in ("TwoGCN", "ThreeGCN") else 0)


@pytest.mark.parametrize("name", MODELS)
def test_bridge_round_trip_is_exact(name):
    _, tctx, params, _ = _model_pair(name)
    back = convert.to_jax(convert.from_jax(params))
    assert sorted(back) == sorted(params)
    for key, value in params.items():
        assert back[key].dtype == value.dtype and np.array_equal(back[key], value), key
    # the port's own init has the JAX keys and shapes
    mine = convert.to_jax(tctx.init(0))
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in params.items()}
    assert all(not mine[k].any() for k in mine if k.endswith("bias"))
