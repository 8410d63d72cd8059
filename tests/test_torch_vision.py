"""The port's vision zoo (LeNet5, DenseNet-40, ResNet) against the JAX package.

Parameters come from the JAX module's own ``init`` and cross through the
weight bridge (``models/convert.py``); inputs are numpy arrays made from a
seed.  Each model is held on its logits, its masked loss and every
gradient, and on its parameter tree: the port's keys and shapes are the
JAX package's, and JAX -> port -> JAX is exact.  Widths are cut (DenseNet
at growth rate 4 on 8x8, ResNet at width 8 with one block a stage); the
odd input size pins XLA's SAME padding at stride 2.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.models import vision as jvision
from distributed_learning_simulator_tpu.models.registry import ModelContext as JaxModelContext
from distributed_learning_simulator_tpu_torch.models import convert, vision
from distributed_learning_simulator_tpu_torch.models.registry import ModelContext

CPU = torch.device("cpu")
N = 4  # samples; the last one is padding (mask 0)

CASES = {
    "lenet5": (
        lambda: jvision.LeNet5(num_classes=10),
        lambda: vision.LeNet5(10, channels=1, image_size=28),
        (28, 1),
    ),
    "densenet40_k4_8x8": (
        lambda: jvision.DenseNet40(num_classes=10, growth_rate=4),
        lambda: vision.DenseNet40(10, growth_rate=4, channels=3),
        (8, 3),
    ),
}
for _bottleneck in (False, True):
    for _size in (8, 9):
        CASES[f"resnet{'_bottleneck' if _bottleneck else ''}_{_size}x{_size}"] = (
            lambda b=_bottleneck: jvision.ResNet(num_classes=10, stage_sizes=(1, 1), width=8, bottleneck=b),
            lambda b=_bottleneck: vision.ResNet(10, stage_sizes=(1, 1), width=8, bottleneck=b, channels=3),
            (_size, 3),
        )


@functools.lru_cache(maxsize=None)
def _jax_reference(case: str):
    """The JAX ModelContext's init params (seed 0) and, on :func:`_batch`,
    its logits, loss, aux counts and gradients, as numpy: one compiled
    init and one compiled gradient a case, shared by the tests."""
    jmodule, _, (size, channels) = CASES[case]
    jctx = JaxModelContext(
        name=case,
        module=jmodule(),
        example_input=np.zeros((1, size, size, channels), np.float32),
        num_classes=10,
    )
    jparams = jax.jit(jctx.init)(jax.random.PRNGKey(0))

    @jax.jit
    def reference(params, batch):
        (loss, aux), grads = jax.value_and_grad(jctx.loss, has_aux=True)(params, batch)
        return jctx.apply(params, batch["input"]), loss, aux, grads

    out = reference(jparams, _batch(size, channels))
    return jax.tree.map(np.asarray, (jparams, *out))


def _port(case: str, jparams) -> ModelContext:
    """The port's model with the JAX params through the bridge."""
    module = CASES[case][1]()
    module.load_state_dict(convert.from_jax(jparams), strict=True)
    return ModelContext(name=case, module=module, num_classes=10, device=CPU)


def _batch(size: int, channels: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return {
        "input": rng.normal(size=(N, size, size, channels)).astype(np.float32),
        "target": rng.integers(0, 10, N).astype(np.int32),
        "mask": np.asarray([1.0] * (N - 1) + [0.0], np.float32),
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_param_tree_and_round_trip_match_jax(case):
    jparams = _jax_reference(case)[0]
    tctx = _port(case, jparams)
    state = tctx.module.state_dict()
    back = convert.to_jax(state)
    assert sorted(back) == sorted(jparams)
    for key, value in jparams.items():
        assert back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # the port's own init draws the same tree
    fresh = tctx.module
    fresh.init_weights(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == {
        k: tuple(v.shape) for k, v in state.items()
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_loss_and_grads_match_jax(case):
    jparams, jlogits, jloss, jaux, jgrads = _jax_reference(case)
    tctx = _port(case, jparams)
    _, _, (size, channels) = CASES[case]
    batch = _batch(size, channels)

    params = {k: v.clone().requires_grad_(True) for k, v in tctx.module.state_dict().items()}
    tlogits = tctx.apply(params, torch.from_numpy(batch["input"]))
    tloss, taux = tctx.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()
    tgrads = convert.to_jax({k: p.grad for k, p in params.items()})

    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    assert float(taux["correct"]) == float(jaux["correct"])
    assert float(taux["count"]) == N - 1
    assert sorted(tgrads) == sorted(jgrads)
    for key, g in jgrads.items():
        # GroupNorm's variance is computed in other ways in the two packages
        np.testing.assert_allclose(tgrads[key], g, rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("size,kernel,stride", [(8, 3, 2), (9, 3, 2), (8, 1, 2), (9, 1, 2), (28, 5, 1), (7, 3, 1)])
def test_same_padding_matches_xla(size, kernel, stride):
    """One convolution at a time: the port's SAME rule (asymmetric at
    stride 2 on an even input) against ``lax.conv_general_dilated``."""
    rng = np.random.default_rng(size * 10 + kernel)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 3, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    )
    conv = vision.Conv(3, 5, kernel, stride, bias=False)
    conv.load_state_dict(convert.from_jax({"kernel": w}))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 3, 6, 12, 16, 20, 28, 100, 256])
def test_gn_groups_agrees_with_jax(channels):
    assert vision._gn_groups(channels) == jvision._gn_groups(channels)


@pytest.mark.parametrize(
    "name,classes,dataset,params",
    [
        ("LeNet5", 10, "MNIST", 61_706),
        ("densenet40", 10, "CIFAR10", 578_090),
        ("densenet40", 100, "CIFAR100", 601_220),
        ("resnet18", 100, "IMAGENET", 11_220_132),
        ("resnet50", 100, "IMAGENET", 23_705_252),
    ],
)
def test_registered_models_at_full_width(name, classes, dataset, params):
    """The factories build the JAX package's full-width trees (counts from
    ``jax.eval_shape`` of the JAX modules)."""
    from distributed_learning_simulator_tpu_torch.config import DistributedTrainingConfig
    from distributed_learning_simulator_tpu_torch.data import create_dataset_collection
    from distributed_learning_simulator_tpu_torch.models import create_model_context

    config = DistributedTrainingConfig(
        dataset_name=dataset, dataset_kwargs={"train_size": 4, "val_size": 4, "test_size": 4}
    )
    ctx = create_model_context(name, create_dataset_collection(config), CPU)
    assert ctx.num_classes == classes
    assert sum(v.numel() for v in ctx.module.state_dict().values()) == params
