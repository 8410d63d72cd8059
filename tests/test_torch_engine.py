"""The port's optimizer, engine, data, partitions and batches against the
JAX package, on inputs made with numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu import native as jnative
from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
from distributed_learning_simulator_tpu.engine import batching as jbatching
from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model
from distributed_learning_simulator_tpu.parallel import spmd as jspmd
from distributed_learning_simulator_tpu.practitioner import create_practitioners as j_practitioners
from distributed_learning_simulator_tpu.utils.selection import select_workers as j_select
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.data import create_dataset_collection as t_create_dc
from distributed_learning_simulator_tpu_torch.engine import batching as tbatching
from distributed_learning_simulator_tpu_torch.engine.engine import ComputeEngine
from distributed_learning_simulator_tpu_torch.engine.hyper_parameter import HyperParameter
from distributed_learning_simulator_tpu_torch.models import convert, create_model_context
from distributed_learning_simulator_tpu_torch.ml_type import MachineLearningPhase as Phase
from distributed_learning_simulator_tpu_torch.ops.pytree import ParamVecLayout, flat_stack_weighted_sum
from distributed_learning_simulator_tpu_torch.parallel import spmd as tspmd
from distributed_learning_simulator_tpu_torch.practitioner import create_practitioners
from distributed_learning_simulator_tpu_torch.sampler import permute_indices
from distributed_learning_simulator_tpu_torch.utils.selection import select_workers

CPU = torch.device("cpu")


def _configs(**fields):
    base = dict(
        dataset_name="CIFAR10",
        model_name="vit_tiny",
        distributed_algorithm="fed_avg",
        worker_number=3,
        batch_size=16,
        dataset_kwargs={"train_size": 100, "val_size": 20, "test_size": 30},
    )
    base.update(fields)
    return jconfig.DistributedTrainingConfig(**base), tconfig.DistributedTrainingConfig(**base)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_sgd_matches_optax_chain_step_by_step(weight_decay, momentum):
    """7 steps over a 3-step periodic cosine: the schedule wraps past
    ``total_steps`` (not clamped) and the trace carries across."""
    total = 3
    kwargs = dict(learning_rate=0.1, momentum=momentum, weight_decay=weight_decay)
    jopt = JaxHP(**kwargs).make_optimizer(total)
    topt = HyperParameter(**kwargs).make_optimizer(total)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=257).astype(np.float32)
    jparams = {"w": jnp.asarray(p0)}
    jstate = jopt.init(jparams)
    tparams = torch.from_numpy(p0.copy())
    tstate = topt.init(tparams)
    for _ in range(7):
        g = rng.normal(size=257).astype(np.float32)
        updates, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step(tparams, torch.from_numpy(g.copy()), tstate)
        # f32 elementwise arithmetic in the same order; fused multiply-add
        # on one side can move the last bit
        np.testing.assert_allclose(tparams.numpy(), np.asarray(jparams["w"]), rtol=1e-6, atol=1e-7)
    assert tstate.count == 7


def test_periodic_cosine_matches_jax_schedule():
    jsched = JaxHP(learning_rate=0.1).make_schedule(4)
    tsched = HyperParameter(learning_rate=0.1).make_schedule(4)
    for count in range(10):
        # float32 on both sides; numpy's and XLA's cos differ by an ulp or two
        np.testing.assert_allclose(
            np.float32(tsched(count)), np.float32(jsched(jnp.int32(count))), rtol=1e-6
        )


def test_sgd_bf16_matches_optax_chain():
    """Under ``use_amp`` the params and the trace are bf16: every scalar is
    rounded to bf16 before it multiplies, as JAX rounds a Python scalar."""
    jopt = JaxHP(learning_rate=0.1).make_optimizer(5)
    topt = HyperParameter(learning_rate=0.1).make_optimizer(5)
    rng = np.random.default_rng(1)
    p0 = torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(torch.bfloat16)
    jparams = {"w": jnp.asarray(p0.float().numpy()).astype(jnp.bfloat16)}
    jstate = jopt.init(jparams)
    tparams, tstate = p0.clone(), topt.init(p0)
    for _ in range(4):
        g = torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(torch.bfloat16)
        updates, jstate = jopt.update(
            {"w": jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)}, jstate, jparams
        )
        jparams = optax.apply_updates(jparams, updates)
        topt.step(tparams, g.clone(), tstate)
    assert tparams.dtype == torch.bfloat16 and tstate.trace.dtype == torch.bfloat16
    # one bf16 ulp (2^-8 relative) where an intermediate rounds differently
    np.testing.assert_allclose(
        tparams.float().numpy(), np.asarray(jparams["w"].astype(jnp.float32)), rtol=8e-3
    )


# ------------------------------------------------------------ engine
def _engines(total_steps=4):
    jc, tc = _configs()
    jdc, tdc = j_create_dc(jc), t_create_dc(tc)
    jctx = j_create_model("vit_tiny", jdc)
    tctx = create_model_context("vit_tiny", tdc, device=CPU)
    jengine = JaxEngine(jctx, JaxHP(learning_rate=0.1), total_steps=total_steps)
    tengine = ComputeEngine(tctx, HyperParameter(learning_rate=0.1), total_steps=total_steps)
    jparams = {k: np.asarray(v) for k, v in jengine.init_params(0).items()}
    return jengine, tengine, jparams


def test_all_padding_batch_is_a_no_op():
    """A batch with no real sample neither moves the params nor decays the
    trace nor advances the schedule; the epoch matches the JAX engine's
    ``train_epoch_fn``, which selects the old state on such a batch."""
    jengine, tengine, jparams = _engines()
    rng = np.random.default_rng(2)
    batches = {
        "input": rng.normal(size=(3, 8, 32, 32, 3)).astype(np.float32),
        "target": rng.integers(0, 10, (3, 8)).astype(np.int32),
        "mask": np.ones((3, 8), np.float32),
    }
    batches["mask"][1] = 0.0  # the middle batch is all padding
    jout, _, jsummed = jengine.train_epoch_fn(
        {k: jnp.asarray(v) for k, v in jparams.items()},
        jengine.init_opt_state({k: jnp.asarray(v) for k, v in jparams.items()}),
        {k: jnp.asarray(v) for k, v in batches.items()},
        jax.random.PRNGKey(0),
    )
    flat = tengine.layout.flatten(convert.from_jax(jparams))
    state = tengine.init_opt_state(flat)
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    tb["target"] = tb["target"].long()
    counts = batches["mask"].sum(-1).tolist()
    before = flat.clone()
    assert tengine.train_step(flat, state, {k: v[1] for k, v in tb.items()}, counts[1]) is None
    assert torch.equal(flat, before) and state.count == 0 and not state.trace.any()
    tsummed = tengine.train_epoch(flat, state, tb, counts)
    assert state.count == 2
    got = convert.to_jax(tengine.layout.split(flat))
    for key, value in jout.items():
        np.testing.assert_allclose(got[key], np.asarray(value), rtol=1e-4, atol=2e-5, err_msg=key)
    assert float(tsummed["count"]) == float(jsummed["count"]) == 16.0
    np.testing.assert_allclose(float(tsummed["loss_sum"]), float(jsummed["loss_sum"]), rtol=1e-5)


def test_evaluate_matches_jax_engine():
    jengine, tengine, jparams = _engines()
    jc, tc = _configs()
    test_j = j_create_dc(jc).get_dataset(Phase.Test)
    batches = jbatching.make_epoch_batches(test_j, 16)
    jsummed = jengine.eval_fn({k: jnp.asarray(v) for k, v in jparams.items()}, batches)
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    tsummed = tengine.evaluate(convert.from_jax(jparams), tb)
    np.testing.assert_allclose(float(tsummed["loss_sum"]), float(jsummed["loss_sum"]), rtol=1e-5)
    assert float(tsummed["correct"]) == float(jsummed["correct"])
    assert float(tsummed["count"]) == float(jsummed["count"]) == 30.0


# ------------------------------------------------------------ data
def test_datasets_are_byte_equal():
    jc, tc = _configs()
    jdc, tdc = j_create_dc(jc), t_create_dc(tc)
    assert set(jdc.datasets) == set(tdc.datasets)
    for phase in tdc.datasets:
        j, t = jdc.get_dataset(phase), tdc.get_dataset(phase)
        assert j.inputs.tobytes() == t.inputs.tobytes()
        assert j.targets.tobytes() == t.targets.tobytes()
    assert (tdc.num_classes, tdc.input_shape) == (jdc.num_classes, jdc.input_shape)


def test_permutation_matches_native_stream():
    assert jnative.available(), "the JAX package's native runtime did not build"
    for n, seed in [(1, 0), (17, 3), (512, 1009 * 2 + 131)]:
        np.testing.assert_array_equal(permute_indices(n, seed), jnative.permute_indices(n, seed))


@pytest.mark.parametrize("workers", [3, 10])
def test_partitions_are_byte_equal(workers):
    jc, tc = _configs(worker_number=workers, seed=7)
    jparts = sorted(j_practitioners(jc), key=lambda p: p.worker_id)
    tparts = create_practitioners(tc)
    for jp, tp in zip(jparts, tparts):
        js = jp.get_sampler("CIFAR10").sample(jp.practitioner_id)
        ts = tp.get_sampler("CIFAR10").sample(tp.practitioner_id)
        assert set(js) == set(ts)
        for phase in ts:
            assert js[phase].tobytes() == ts[phase].tobytes()


@pytest.mark.parametrize("batch_size", [16, 30, 64])
def test_epoch_batches_are_byte_equal(batch_size):
    """Padded to whole batches with zero-weight samples, in dataset order."""
    jc, tc = _configs()
    j = j_create_dc(jc).get_dataset(Phase.Test)
    t = t_create_dc(tc).get_dataset(Phase.Test)
    jb = jbatching.make_epoch_batches(j, batch_size)
    tb = tbatching.make_epoch_batches(t, batch_size)
    for key in ("input", "target", "mask"):
        assert jb[key].dtype == tb[key].dtype and jb[key].shape == tb[key].shape
        assert jb[key].tobytes() == tb[key].tobytes()


def test_client_stacks_are_byte_equal():
    jc, tc = _configs(worker_number=3, epoch=2)
    jdc, tdc = j_create_dc(jc), t_create_dc(tc)
    jparts, tparts = j_practitioners(jc), create_practitioners(tc, tdc)
    jdata, jsizes, jn = jspmd.stack_client_data(jc, jdc, jparts, 3)
    tdata, tsizes, tn = tspmd.stack_client_data(tc, tdc, tparts, 3)
    assert jn == tn and jsizes.tobytes() == tsizes.tobytes()
    jval = jspmd.stack_client_val_data(jc, jdc, jparts, 3)
    tval = tspmd.stack_client_val_data(tc, tdc, tparts, 3)
    for jd, td in ((jdata, tdata), (jval, tval)):
        for key in ("input", "target", "mask"):
            assert jd[key].tobytes() == td[key].tobytes()


# ------------------------------------------------------------ layout
def test_param_vec_layout_round_trip_and_views():
    params = {
        "b": torch.arange(6.0).reshape(2, 3),
        "a": torch.tensor([7.0, 8.0]),
        "c": torch.ones(1, 1, 2),
    }
    layout = ParamVecLayout.of(params)
    assert layout.keys == ("a", "b", "c") and layout.size == 10
    vec = layout.flatten(params)
    np.testing.assert_array_equal(vec.numpy(), [7, 8, 0, 1, 2, 3, 4, 5, 1, 1])
    views = layout.split(vec)
    views["b"][1, 2] = -1.0  # a view: writes land in the vector
    assert vec[7] == -1.0
    assert not layout.matches({**params, "b": params["b"].T})
    with pytest.raises(ValueError):
        layout.split(torch.zeros(9))


def test_flat_stack_weighted_sum_is_the_weighted_row_sum():
    rows = torch.arange(12.0).reshape(3, 4).to(torch.bfloat16)
    out = flat_stack_weighted_sum(rows, torch.tensor([1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(out.numpy(), [16.0, 19.0, 22.0, 25.0])


# ------------------------------------------------------------ config
def test_config_loads_like_jax():
    argv = [
        "--config-name",
        "fed_avg/cifar10.yaml",
        "++fed_avg.model_name=vit_small",
        "++fed_avg.use_amp=true",
        "++fed_avg.algorithm_kwargs.client_chunk=2",
        "++fed_avg.save_dir=unused",
    ]
    j, t = jconfig.load_config(argv), tconfig.load_config(argv)
    tfields = dataclasses.asdict(t)
    assert tfields.pop("device") == "cuda"
    assert tfields == dataclasses.asdict(j)


@pytest.mark.parametrize("k", [None, 3, 10])
def test_selection_matches_jax(k):
    for round_number in range(1, 5):
        assert select_workers(0, round_number, 10, k) == j_select(0, round_number, 10, k)


def test_param_vec_layout_splits_the_rows_of_a_matrix():
    """An ``[S, size]`` matrix (rows on a padded stride, as the graph
    sessions lay them out) splits into ``[S, *shape]`` views of its rows."""
    params = {"b": torch.arange(6.0).reshape(2, 3), "a": torch.tensor([7.0, 8.0])}
    layout = ParamVecLayout.of(params)
    rows = torch.zeros(3, 16)[:, : layout.size]
    rows.copy_(layout.flatten(params))
    views = layout.split(rows)
    assert views["b"].shape == (3, 2, 3) and views["a"].shape == (3, 2)
    views["b"][2, 1, 0] = -1.0
    assert rows[2, 5] == -1.0 and rows[1, 5] == 3.0
    for s in range(3):
        assert all(torch.equal(views[k][s], layout.split(rows[s])[k]) for k in params)
    with pytest.raises(ValueError):
        layout.split(torch.zeros(3, 9))
