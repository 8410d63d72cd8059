"""The port's long-context slice against the JAX package: text data, the
weight bridge, ``LongContextTransformer`` / ``CausalLMTransformer``,
dropout, and FedAvg trajectories.

Parameters come from the JAX package's ``init`` and cross the bridge
(``models/convert.py``); inputs are the byte-equal synthetic text or numpy
arrays made from a seed.  At T = 128 the JAX models run their Pallas
attention kernel under the interpreter (``DLS_TPU_FUSED_ATTN=interpret``)
and the port its dense route; at T = 1024 the port runs its kernel route
(plain versions on the CPU) and JAX its dense route.  A JAX FedAvg run on
the CPU takes ``dense_attention``.
"""

import os
import types

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
from distributed_learning_simulator_tpu_torch.data import create_dataset_collection as t_create_dc
from distributed_learning_simulator_tpu_torch.ml_type import MachineLearningPhase as Phase
from distributed_learning_simulator_tpu_torch.models import convert, create_model_context
from distributed_learning_simulator_tpu_torch.models.dropout import Dropout, dropout_generator
from distributed_learning_simulator_tpu_torch.ops import fused_attention as tfa
from distributed_learning_simulator_tpu_torch.parallel.spmd import SpmdFedAvgSession, stack_client_data
from distributed_learning_simulator_tpu_torch.practitioner import create_practitioners
from distributed_learning_simulator_tpu_torch.training import build_session
from distributed_learning_simulator_tpu_torch.training import train as torch_train

CPU = torch.device("cpu")
# 2 layers, d_model 128, 2 heads (Dh 64), T 128, vocab 512
WIDTH = dict(d_model=128, nhead=2, num_encoder_layer=2, dropout_rate=0.0)
TEXT = dict(max_len=128, vocab_size=512, train_size=8, val_size=4, test_size=4)


def _configs(dataset_kwargs=TEXT, **fields):
    base = dict(
        dataset_name="imdb",
        model_name="LongContextTransformer",
        distributed_algorithm="fed_avg",
        worker_number=2,
        batch_size=4,
        dataset_kwargs=dict(dataset_kwargs),
    )
    base.update(fields)
    return jconfig.DistributedTrainingConfig(**base), tconfig.DistributedTrainingConfig(**base)


def _pair(model, width=WIDTH, text=TEXT, seed=0):
    """The JAX ModelContext with its init params, and the port's with the
    same params through the bridge."""
    jc, tc = _configs(text)
    jctx = j_create_model(model, j_create_dc(jc), **width)
    jparams = {k: np.asarray(v) for k, v in jctx.init(jax.random.PRNGKey(seed)).items()}
    tctx = create_model_context(model, t_create_dc(tc), device=CPU, **width)
    tctx.module.load_state_dict(convert.from_jax(jparams), strict=True)
    return jctx, jparams, tctx


def _batch(text=TEXT, n=4):
    _, tc = _configs(text)
    train = t_create_dc(tc).get_dataset(Phase.Training)
    return {
        "input": train.inputs[:n],
        "target": train.targets[:n],
        "mask": np.asarray([1.0] * (n - 1) + [0.0], np.float32),
    }


def _compare_model(model, width=WIDTH, text=TEXT, dtype=torch.float32):
    """Logits, loss, counts and gradients of both packages on one batch."""
    jctx, jparams, tctx = _pair(model, width, text)
    batch = _batch(text)
    if dtype == torch.bfloat16:
        jctx.compute_dtype = jnp.bfloat16
        tctx.compute_dtype = torch.bfloat16
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    jlogits = np.asarray(jctx.apply(jctx._cast_for_compute(jp), batch["input"]).astype(jnp.float32))
    (jloss, jaux), jgrads = jax.value_and_grad(jctx.loss, has_aux=True)(jp, batch)

    params = {k: v.clone().requires_grad_(True) for k, v in tctx.module.state_dict().items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits = tctx.apply(tctx._cast_for_compute(params), tbatch["input"]).float()
    tloss, taux = tctx.loss(params, tbatch)
    tloss.backward()
    tgrads = convert.to_jax({k: p.grad for k, p in params.items()})
    assert float(taux["count"]) == float(jaux["count"])
    assert sorted(tgrads) == sorted(jgrads)
    return (jlogits, float(jloss), jgrads), (tlogits.detach().numpy(), float(tloss.detach()), tgrads)


@pytest.fixture()
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DLS_TPU_FUSED_ATTN", "interpret")


# ---------------------------------------------------------------- models
@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("model", ["LongContextTransformer", "CausalLMTransformer"])
def test_model_f32_matches_jax(model):
    (jlogits, jloss, jgrads), (tlogits, tloss, tgrads) = _compare_model(model)
    # f32 throughout; summation order only, through two layers
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for key, g in jgrads.items():
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(tgrads[key], g, atol=2e-4 * scale, err_msg=key)


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("model", ["LongContextTransformer", "CausalLMTransformer"])
def test_model_bf16_tracks_jax(model):
    """``use_amp``: bf16 params, inputs and activations in both, the loss
    in f32.  bf16 keeps 8 significant bits and the two frameworks round at
    other points (matmul accumulation, LayerNorm, GELU, pooling): logits
    within 4 bf16 ulps (2^-5) of their largest magnitude; a gradient within
    10% of its leaf's largest (bias gradients sum a batch of bf16 terms
    rounded at other points; 4.5% was the worst seen)."""
    (jlogits, jloss, jgrads), (tlogits, tloss, tgrads) = _compare_model(model, dtype=torch.bfloat16)
    np.testing.assert_allclose(tlogits, jlogits, atol=2**-5 * float(np.abs(jlogits).max()))
    np.testing.assert_allclose(tloss, jloss, rtol=5e-3)
    for key, g in jgrads.items():
        g = np.asarray(g, np.float32)
        gscale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(tgrads[key], g, atol=0.1 * gscale, err_msg=key)


def test_model_kernel_route_matches_jax_dense():
    """At T = 1024 the port routes attention to K6-K11 (their plain
    versions here) while JAX on the CPU takes ``dense_attention``."""
    width = dict(d_model=64, nhead=2, num_encoder_layer=1, dropout_rate=0.0)
    text = dict(TEXT, max_len=1024)
    assert tfa.kernel_tier(1024, 32, 4) == "fused"
    (jlogits, jloss, jgrads), (tlogits, tloss, tgrads) = _compare_model(
        "CausalLMTransformer", width, text
    )
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for key, g in jgrads.items():
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(tgrads[key], g, atol=2e-4 * scale, err_msg=key)
    assert all(n == 0 for n in tfa.launches.values())


def test_sequence_parallel_is_refused():
    _, tc = _configs()
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        create_model_context("LongContextTransformer", t_create_dc(tc), device=CPU, sp_axis="sp")
    _, tc = _configs(model_kwargs={"sequence_parallel": 4, "sp_impl": "ring"}, save_dir="unused")
    with pytest.raises(NotImplementedError):
        torch_train(tc, device="cpu")


# ---------------------------------------------------------------- bridge
@pytest.mark.parametrize("model", ["LongContextTransformer", "CausalLMTransformer"])
def test_bridge_round_trip_is_exact(model):
    _, jparams, tctx = _pair(model)
    back = convert.to_jax(tctx.module.state_dict())
    assert sorted(back) == sorted(jparams)
    for key, value in jparams.items():
        assert back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value)


def test_bridge_maps_the_dense_general_qkv_by_path():
    """``qkv/kernel [D, 3, H, Dh]`` becomes the packed projection's
    ``[3, H, Dh, D]`` (element [s, h, e, i] = kernel[i, s, h, e]); its bias
    stays ``[3, H, Dh]``; a 4-d kernel under another name is still a
    convolution; the embedding table is kept as it is."""
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(8, 3, 2, 4)).astype(np.float32)
    bias = rng.normal(size=(3, 2, 4)).astype(np.float32)
    embed = rng.normal(size=(10, 8)).astype(np.float32)
    out = convert.from_jax(
        {"L/qkv/kernel": kernel, "L/qkv/bias": bias, "c/kernel": kernel, "Embed_0/embedding": embed}
    )
    assert out["L.qkv.weight"].shape == (3, 2, 4, 8)
    np.testing.assert_array_equal(out["L.qkv.weight"].numpy()[2, 1, 3, 5], kernel[5, 2, 1, 3])
    np.testing.assert_array_equal(out["L.qkv.bias"].numpy(), bias)
    assert out["c.weight"].shape == (4, 2, 8, 3)  # HWIO -> OIHW
    np.testing.assert_array_equal(out["Embed_0.embedding"].numpy(), embed)
    back = convert.to_jax(out)
    for key, value in (("L/qkv/kernel", kernel), ("L/qkv/bias", bias), ("c/kernel", kernel)):
        np.testing.assert_array_equal(back[key], value)


# ---------------------------------------------------------------- dropout
def test_dropout_keep_rate_and_scale():
    layer = Dropout(0.25).train()
    x = torch.ones(1000, 1000)
    y = layer(x, dropout_generator(0, 1, 0, CPU))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005  # ~30 sigma of 1e6 draws is 0.013
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.75))
    assert layer.eval()(x) is x
    assert Dropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match="Generator"):
        layer.train()(x)


def test_dropout_is_seeded_and_leaves_the_global_rng_alone():
    width = dict(WIDTH, dropout_rate=0.1)
    _, _, tctx = _pair("LongContextTransformer", width)
    tokens = torch.from_numpy(_batch()["input"])
    params = tctx.module.state_dict()
    state = torch.get_rng_state()

    def run(*key):
        return tctx.apply(params, tokens, train=True, generator=dropout_generator(*key, CPU))

    a, b, c, d = run(0, 1, 0), run(0, 1, 0), run(0, 1, 1), run(0, 2, 0)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(tctx.apply(params, tokens), tctx.apply(params, tokens))


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("name", ["imdb", "IMDB", "AGNews"])
def test_text_data_is_byte_equal(name):
    kwargs = dict(max_len=96, vocab_size=700, train_size=40, val_size=8, test_size=12)
    jc, tc = _configs(kwargs, dataset_name=name)
    jdc, tdc = j_create_dc(jc), t_create_dc(tc)
    assert tdc.metadata == jdc.metadata
    assert (tdc.num_classes, tdc.input_shape, tdc.dataset_type) == (jdc.num_classes, jdc.input_shape, "text")
    for phase in tdc.datasets:
        j, t = jdc.get_dataset(phase), tdc.get_dataset(phase)
        assert t.inputs.dtype == j.inputs.dtype == np.int32
        assert t.inputs.tobytes() == j.inputs.tobytes()
        assert t.targets.tobytes() == j.targets.tobytes()


def test_tokenizer_types_are_checked():
    for tokenizer in ("spacy", {"type": "regex"}):
        _, tc = _configs(dict(TEXT, tokenizer=tokenizer))
        t_create_dc(tc)
    _, tc = _configs(dict(TEXT, tokenizer={"type": "bpe"}))
    with pytest.raises(ValueError, match="tokenizer"):
        t_create_dc(tc)


def test_token_ids_survive_to_device_under_amp():
    """Integer inputs stay integer on the device: bf16 holds integers
    exactly only up to 256, so a cast would change the ids."""
    ids = np.arange(250, 20250, dtype=np.int32).reshape(4, 5, 1000)
    host = {"input": ids, "target": np.zeros((4, 5), np.int32), "mask": np.ones((4, 5), np.float32)}
    fake = types.SimpleNamespace(device=CPU, model_ctx=types.SimpleNamespace(compute_dtype=torch.bfloat16))
    staged = SpmdFedAvgSession._to_device(fake, host)
    assert staged["input"].dtype == torch.int64
    np.testing.assert_array_equal(staged["input"].numpy(), ids)
    floats = {**host, "input": ids.astype(np.float32)}
    assert SpmdFedAvgSession._to_device(fake, floats)["input"].dtype == torch.bfloat16


def test_session_stages_token_ids_exactly(tmp_path):
    _, tc = _configs(
        dict(TEXT, vocab_size=20000),
        use_amp=True,
        model_kwargs=dict(WIDTH),
        save_dir=str(tmp_path / "s"),
        log_file=str(tmp_path / "s.log"),
    )
    session = build_session(tc, device="cpu")
    staged = session._data["input"]
    dc = t_create_dc(tc)
    host, _, _ = stack_client_data(tc, dc, create_practitioners(tc, dc), tc.worker_number)
    assert staged.dtype == torch.int64 and int(staged.max()) > 256
    np.testing.assert_array_equal(staged.numpy(), host["input"])


def test_causal_lm_counts_tokens(tmp_path):
    """The host counts that gate the engine's no-op are the loss's own
    counts: tokens with a non-pad target, not samples."""
    _, tc = _configs(
        dict(TEXT, max_len=16, train_size=12),
        model_name="CausalLMTransformer",
        worker_number=2,
        model_kwargs=dict(WIDTH),
        save_dir=str(tmp_path / "s"),
        log_file=str(tmp_path / "s.log"),
    )
    session = build_session(tc, device="cpu")
    params = session.engine.init_params(0)
    seen = 0
    for slot, counts in enumerate(session._counts):
        for i, count in enumerate(counts):
            batch = {k: v[slot, i] for k, v in session._data.items()}
            _, aux = session.model_ctx.loss(params, batch)
            assert count == float(aux["count"])
            seen += count > float(batch["mask"].sum())
    assert seen  # some batch counts more tokens than samples


# ---------------------------------------------------------------- FedAvg
ROUNDS = 2
TRAJ_TEXT = dict(max_len=64, vocab_size=512, train_size=16, val_size=4, test_size=8)
TRAJ_WIDTH = dict(d_model=32, nhead=2, num_encoder_layer=2, max_len=64, dropout_rate=0.0)


def _traj_fields(tmp_path, name, model, **extra):
    fields = dict(
        dataset_name="imdb",
        model_name=model,
        distributed_algorithm="fed_avg",
        worker_number=2,
        batch_size=4,
        round=ROUNDS,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs=dict(TRAJ_TEXT),
        model_kwargs=dict(TRAJ_WIDTH),
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


def _final_params(config):
    path = os.path.join(config.save_dir, "aggregated_model", f"round_{config.round}.npz")
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


@pytest.mark.parametrize("model", ["LongContextTransformer", "CausalLMTransformer"])
def test_fed_avg_trajectory_matches_jax(tmp_path, model):
    """2 clients x 2 rounds from one JAX init: per-round test loss,
    accuracy and count, and the final parameters.  f32 SGD in other
    summation orders moves the loss in its 5th-6th digit."""
    init = tmp_path / "init.npz"
    jc = jconfig.DistributedTrainingConfig(**_traj_fields(tmp_path, "init", model))
    ctx = j_create_model(model, j_create_dc(jc), **TRAJ_WIDTH)
    params = JaxEngine(ctx, JaxHP(), total_steps=1).init_params(0)
    np.savez(init, **{k: np.asarray(v) for k, v in params.items()})
    kwargs = {"algorithm_kwargs": {"global_model_path": str(init)}}
    jc = jconfig.DistributedTrainingConfig(**_traj_fields(tmp_path, "jax", model, **kwargs))
    tc = tconfig.DistributedTrainingConfig(**_traj_fields(tmp_path, "torch", model, **kwargs))
    jres = jax_train(jc)["performance"]
    tres = torch_train(tc, device="cpu")["performance"]
    assert sorted(tres) == sorted(jres) == list(range(1, ROUNDS + 1))
    for r in jres:
        np.testing.assert_allclose(tres[r]["test_loss"], jres[r]["test_loss"], rtol=1e-4)
        assert tres[r]["test_accuracy"] == jres[r]["test_accuracy"]
        assert tres[r]["test_count"] == jres[r]["test_count"]  # tokens for the LM
    jparams, tparams = _final_params(jc), _final_params(tc)
    assert sorted(tparams) == sorted(jparams)
    for key, value in jparams.items():
        np.testing.assert_allclose(tparams[key], value, rtol=1e-4, atol=1e-5, err_msg=key)
