"""The port's ViT, IMDB text classifier, attention routing and weight bridge
against the JAX package.

Parameters come from the JAX package's own ``init`` and cross through the
bridge (``models/convert.py``); inputs are numpy arrays made from a seed.
The JAX attention runs its short-sequence Pallas kernel under the
interpreter (``DLS_TPU_FUSED_ATTN=interpret``); the port runs the kernels'
plain versions on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.models import text as jtext
from distributed_learning_simulator_tpu.models import vit as jvit
from distributed_learning_simulator_tpu.models.registry import ModelContext as JaxModelContext
from distributed_learning_simulator_tpu.ops import pytree as jflat
from distributed_learning_simulator_tpu.ops import short_attention as jsa
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.models.attention import FusedSelfAttention
from distributed_learning_simulator_tpu_torch.models.registry import ModelContext
from distributed_learning_simulator_tpu_torch.models.text import EncoderLayer, TransformerClassifier
from distributed_learning_simulator_tpu_torch.models.vit import VisionTransformer
from distributed_learning_simulator_tpu_torch.ops import short_attention as tsa

CPU = torch.device("cpu")
# d_model 128, 2 heads (Dh 64, short-kernel eligible), 2 layers, 8x8 patches
WIDTH = dict(d_model=128, num_layers=2, num_heads=2, mlp_dim=256)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DLS_TPU_FUSED_ATTN", "interpret")


def _pair(width=WIDTH, patch=4, seed=0):
    """The JAX ModelContext with its init params, and the port's with the
    same params through the bridge."""
    example = np.zeros((1, 32, 32, 3), np.float32)
    jctx = JaxModelContext(
        name="vit",
        module=jvit.VisionTransformer(num_classes=10, patch_size=patch, **width),
        example_input=example,
        num_classes=10,
    )
    jparams = {k: np.asarray(v) for k, v in jctx.init(jax.random.PRNGKey(seed)).items()}
    module = VisionTransformer(
        num_classes=10, image_size=32, channels=3, patch_size=patch, **width
    )
    module.load_state_dict(convert.from_jax(jparams), strict=True)
    tctx = ModelContext(name="vit", module=module, num_classes=10, device=CPU)
    return jctx, jparams, tctx


def _batch(n=4, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "input": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
        "target": rng.integers(0, 10, n).astype(np.int32),
        "mask": np.asarray([1.0] * (n - 1) + [0.0], np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("width,patch", [(WIDTH, 4), (dict(d_model=32, num_layers=2, num_heads=2, mlp_dim=64), 8)])
def test_bridge_round_trip_is_exact(width, patch):
    _, jparams, tctx = _pair(width, patch)
    back = convert.to_jax(tctx.module.state_dict())
    assert sorted(back) == sorted(jparams)
    for key, value in jparams.items():
        assert back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value)


def test_bridge_layouts():
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(3, 5)).astype(np.float32)
    conv = rng.normal(size=(4, 4, 3, 8)).astype(np.float32)
    out = convert.from_jax(
        {"a/kernel": dense, "c/kernel": conv, "n/scale": np.ones(5, np.float32), "pos_embed": dense}
    )
    assert out["a.weight"].shape == (5, 3)
    assert out["c.weight"].shape == (8, 3, 4, 4)
    assert out["n.weight"].shape == (5,) and "pos_embed" in out
    np.testing.assert_array_equal(out["c.weight"].numpy()[7, 2, 1, 0], conv[1, 0, 2, 7])


def test_vit_logits_loss_and_grads_match_jax():
    jctx, jparams, tctx = _pair()
    batch = _batch()
    jlogits = np.asarray(jctx.apply({k: jnp.asarray(v) for k, v in jparams.items()}, batch["input"]))
    (jloss, jaux), jgrads = jax.value_and_grad(jctx.loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in jparams.items()}, batch
    )

    params = {k: v.clone().requires_grad_(True) for k, v in tctx.module.state_dict().items()}
    tlogits = tctx.apply(params, torch.from_numpy(batch["input"]))
    tloss, taux = tctx.loss(params, _torch_batch(batch))
    tloss.backward()
    tgrads = convert.to_jax({k: p.grad for k, p in params.items()})

    # f32 throughout; the two differ in summation order only, through two
    # blocks and a 10-way head
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    assert float(taux["correct"]) == float(jaux["correct"])
    assert float(taux["count"]) == 3.0
    assert sorted(tgrads) == sorted(jgrads)
    for key, g in jgrads.items():
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(tgrads[key], g, atol=2e-4 * scale, err_msg=key)


def test_vit_bf16_compute_matches_jax():
    """``use_amp``: both run the forward on bf16 params and inputs and the
    loss in f32."""
    jctx, jparams, tctx = _pair()
    jctx.compute_dtype = jnp.bfloat16
    tctx.compute_dtype = torch.bfloat16
    batch = _batch()
    jloss, _ = jctx.loss({k: jnp.asarray(v) for k, v in jparams.items()}, batch)
    tloss, _ = tctx.loss(tctx.module.state_dict(), _torch_batch(batch))
    # bf16 keeps ~3 significant digits; rounding points differ between the
    # two frameworks (matmul accumulation, LayerNorm, GELU)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=3e-2)


@pytest.mark.parametrize("s", [16, 50, 64, 128, 197, 256, 1024, 1025, 2048])
@pytest.mark.parametrize("d,h", [(384, 6), (128, 2), (512, 4), (96, 3), (100, 5), (768, 12)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_short_eligible_agrees_with_jax(s, d, h, itemsize):
    assert tsa.short_eligible(s, d, h, itemsize) == jsa.short_eligible(s, d, h, itemsize)


def test_attention_routes_long_sequences_to_unported_kernels():
    attn = FusedSelfAttention(d_model=128, num_heads=2)
    with pytest.raises(NotImplementedError, match="K6-K11"):
        attn(torch.zeros(1, 2048, 128))


def test_attention_dense_path_matches_jax():
    """Dh = 16 is not short-eligible: both packages take the dense path."""
    from distributed_learning_simulator_tpu.models.attention import (
        FusedSelfAttention as JaxAttention,
    )

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    mask = np.ones((2, 1, 1, 16), bool)
    mask[1, ..., 10:] = False
    jmod = JaxAttention(num_heads=2)
    jparams = jmod.init(jax.random.PRNGKey(0), x)
    jout = np.asarray(jmod.apply(jparams, x, mask=mask))
    flat = {
        f"{mod}/{leaf}": np.asarray(v)
        for mod, leaves in jparams["params"].items()
        for leaf, v in leaves.items()
    }
    tmod = FusedSelfAttention(d_model=32, num_heads=2)
    tmod.load_state_dict(convert.from_jax(flat), strict=True)
    tout = tmod(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)


# ----------------------------------------------- the IMDB text classifier
TEXT = dict(vocab_size=50, num_classes=3, d_model=32, nhead=2, max_len=16)


@functools.lru_cache(maxsize=None)
def _text_reference(layers: int):
    """The JAX classifier's init params and, on :func:`_text_batch`, its
    logits, loss, aux counts and gradients (eval mode), as numpy."""
    jctx = JaxModelContext(
        name="TransformerClassificationModel",
        module=jtext.TransformerClassifier(num_encoder_layer=layers, **TEXT),
        example_input=np.ones((1, TEXT["max_len"]), np.int32),
        num_classes=TEXT["num_classes"],
        dataset_type="text",
    )
    jparams = jax.jit(jctx.init)(jax.random.PRNGKey(layers))

    @jax.jit
    def reference(params, batch):
        (loss, aux), grads = jax.value_and_grad(jctx.loss, has_aux=True)(params, batch)
        return jctx.apply(params, batch["input"]), loss, aux, grads

    out = reference(jparams, _text_batch())
    return jax.tree.map(np.asarray, (jparams, *out))


def _text_batch(seed=5):
    """Rows of lengths 16, 11 and 3 (the rest pad, id 0), then one row that
    is all padding and weighs 0."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, TEXT["vocab_size"], size=(4, TEXT["max_len"])).astype(np.int32)
    for row, length in enumerate((16, 11, 3, 0)):
        tokens[row, length:] = 0
    return {
        "input": tokens,
        "target": rng.integers(0, TEXT["num_classes"], 4).astype(np.int32),
        "mask": np.asarray([1.0, 1.0, 1.0, 0.0], np.float32),
    }


def _text_port(layers: int, jparams) -> ModelContext:
    module = TransformerClassifier(num_encoder_layer=layers, **TEXT)
    module.load_state_dict(convert.from_jax(jparams), strict=True)
    return ModelContext(name="text", module=module, num_classes=TEXT["num_classes"], device=CPU)


@pytest.mark.parametrize("layers", [1, 2])
def test_text_classifier_tree_and_round_trip_match_jax(layers):
    jparams = _text_reference(layers)[0]
    tctx = _text_port(layers, jparams)
    back = convert.to_jax(tctx.module.state_dict())
    assert sorted(back) == sorted(jparams)
    assert jparams["EncoderLayer_0/FusedSelfAttention_0/qkv/kernel"].ndim == 2
    for key, value in jparams.items():
        assert back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("layers", [1, 2])
def test_text_classifier_logits_loss_and_grads_match_jax(layers):
    jparams, jlogits, jloss, jaux, jgrads = _text_reference(layers)
    tctx = _text_port(layers, jparams)
    batch = _text_batch()
    params = {k: v.clone().requires_grad_(True) for k, v in tctx.module.state_dict().items()}
    tlogits = tctx.apply(params, torch.from_numpy(batch["input"]))
    tloss, taux = tctx.loss(params, _torch_batch(batch))
    tloss.backward()
    tgrads = convert.to_jax({k: p.grad for k, p in params.items()})

    # the all-padding row pools to 0 in both: its logits are the head's bias
    np.testing.assert_allclose(tlogits.detach().numpy()[3], jparams["Dense_0/bias"], atol=1e-7)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    assert float(taux["correct"]) == float(jaux["correct"])
    assert float(taux["count"]) == 3.0
    assert sorted(tgrads) == sorted(jgrads)
    for key, g in jgrads.items():
        np.testing.assert_allclose(tgrads[key], g, rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_layer_matches_jax(activation):
    """The BERT family's placement (gelu) as well as the classifier's, in
    eval mode, where the dropout toggles are the identity."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    pad = np.ones((2, 8), bool)
    pad[1, 5:] = False
    kwargs = dict(activation=activation, attn_out_dropout=True, ffn_dropout_on_output=True)
    jmod = jtext.EncoderLayer(32, 2, 64, **kwargs)
    jvars = jmod.init(jax.random.PRNGKey(0), x, pad)
    jout = np.asarray(jmod.apply(jvars, x, pad))
    tmod = EncoderLayer(32, 2, 64, **kwargs)
    tmod.load_state_dict(convert.from_jax(jflat.flatten_nested(jvars["params"])), strict=True)
    tout = tmod.eval()(torch.from_numpy(x), torch.from_numpy(pad)).detach().numpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)


def test_encoder_layer_ffn_hook_is_refused():
    with pytest.raises(NotImplementedError, match="ffn"):
        EncoderLayer(32, 2, 64, ffn=torch.nn.Identity())


@pytest.mark.parametrize(
    "model_kwargs,vocab,refused",
    [
        ({}, False, False),
        ({"word_vector_name": "glove.6B.100d"}, False, False),
        ({"word_vector_name": "glove.6B.100d"}, True, True),
        ({"pipeline_stages": 1}, False, True),
        ({"pipeline_stages": 4}, False, True),
        ({"pp_axis": "pp"}, False, True),
    ],
)
def test_text_classifier_factory(model_kwargs, vocab, refused):
    """As the JAX factory: without a dataset vocab (every synthetic
    dataset) ``word_vector_name`` trains the embedding from its init; the
    GloVe override and the stacked trunk are refused."""
    from distributed_learning_simulator_tpu_torch.config import DistributedTrainingConfig
    from distributed_learning_simulator_tpu_torch.data import create_dataset_collection
    from distributed_learning_simulator_tpu_torch.models import create_model_context

    config = DistributedTrainingConfig(
        dataset_name="imdb", dataset_kwargs={"max_len": 16, "train_size": 4, "val_size": 4, "test_size": 4}
    )
    dc = create_dataset_collection(config)
    if vocab:
        dc.metadata["vocab"] = ["<pad>", "a", "b"]
    make = lambda: create_model_context(  # noqa: E731
        "TransformerClassificationModel", dc, CPU, d_model=32, nhead=2, **model_kwargs
    )
    if refused:
        with pytest.raises(NotImplementedError):
            make()
    else:
        ctx = make()
        assert ctx.dataset_type == "text" and ctx.num_classes == 2
        assert tuple(ctx.module.Embed_0.embedding.shape) == (20000, 32)
