"""The port's BERT family (``models/bert.py``) against the JAX package's.

* ``BertClassifier``'s logits, loss and per-leaf gradients on the same
  bridged parameters and numpy-seeded tokens with padding: at d_model 128,
  2 heads (Dh 64: the short-attention kernels K4/K5, whose plain versions
  run here against JAX's Pallas kernels under the interpreter,
  ``DLS_TPU_FUSED_ATTN=interpret``, R3), in train and eval mode at
  ``dropout_rate`` 0; and ``bert_tiny`` (Dh 16) on the dense path;
* the weight bridge round trip on ``bert_small``, exact;
* a 2-round ``bert_tiny`` FedAvg trajectory, JAX ``train()`` against the
  port's;
* ``conf/large_scale/fed_avg/bert_agnews.yaml`` for one round at full
  width (``bert_base``, ``use_amp``, ``client_chunk: auto``), cut to 16
  workers, 2 selected, batch 1 and 16 training samples.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.models import bert as jbert
from distributed_learning_simulator_tpu.models.registry import ModelContext as JaxModelContext
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch.models import convert
from distributed_learning_simulator_tpu_torch.models.bert import BertClassifier
from distributed_learning_simulator_tpu_torch.models.registry import ModelContext
from distributed_learning_simulator_tpu_torch.ops import short_attention as tsa
from distributed_learning_simulator_tpu_torch.training import train as torch_train

CPU = torch.device("cpu")
VOCAB, CLASSES, MAX_LEN = 100, 4, 32
#: d_model 128, 2 heads: Dh 64, short-kernel eligible; bert_tiny's widths: Dh 16, dense
WIDTHS = {
    "d128": dict(d_model=128, num_layers=2, num_heads=2, mlp_dim=256),
    "bert_tiny": dict(d_model=32, num_layers=2, num_heads=2, mlp_dim=64),
    "bert_small": dict(d_model=256, num_layers=4, num_heads=4, mlp_dim=1024),
}


@pytest.fixture
def interpret_mode(monkeypatch):
    """JAX's K4/K5 under the Pallas interpreter.  Not for whole ``train()``
    runs: the interpreter's callbacks deadlock against the JAX session's
    checkpoint writer thread."""
    monkeypatch.setenv("DLS_TPU_FUSED_ATTN", "interpret")


def _batch(seed=3):
    """Rows of lengths 32, 20 and 5 (the rest pad, id 0), then one row
    that is all padding and weighs 0."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, size=(4, MAX_LEN)).astype(np.int32)
    for row, length in enumerate((32, 20, 5, 0)):
        tokens[row, length:] = 0
    return {
        "input": tokens,
        "target": rng.integers(0, CLASSES, 4).astype(np.int32),
        "mask": np.asarray([1.0, 1.0, 1.0, 0.0], np.float32),
    }


def _jax_ctx(width: str):
    module = jbert.BertClassifier(
        vocab_size=VOCAB, num_classes=CLASSES, max_len=MAX_LEN, dropout_rate=0.0, **WIDTHS[width]
    )
    return JaxModelContext(
        name="bert",
        module=module,
        example_input=np.ones((1, MAX_LEN), np.int32),
        num_classes=CLASSES,
        dataset_type="text",
    )


@functools.lru_cache(maxsize=None)
def _reference(width: str, train: bool):
    """The JAX classifier's init params and, on :func:`_batch`, its logits,
    loss, aux counts and gradients, as numpy."""
    jctx = _jax_ctx(width)
    jparams = jax.jit(jctx.init)(jax.random.PRNGKey(0))

    @jax.jit
    def reference(params, batch):
        loss_fn = functools.partial(jctx.loss, train=train)
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
        return jctx.apply(params, batch["input"], train=train), loss, aux, grads

    out = reference(jparams, _batch())
    return jax.tree.map(np.asarray, (jparams, *out))


def _port(width: str, jparams) -> ModelContext:
    module = BertClassifier(
        vocab_size=VOCAB, num_classes=CLASSES, max_len=MAX_LEN, dropout_rate=0.0, **WIDTHS[width]
    )
    module.load_state_dict(convert.from_jax(jparams), strict=True)
    return ModelContext(name="bert", module=module, num_classes=CLASSES, device=CPU, dataset_type="text")


@pytest.mark.parametrize(
    "width,train", [("d128", False), ("d128", True), ("bert_tiny", False), ("bert_tiny", True)]
)
def test_logits_loss_and_grads_match_jax(interpret_mode, width, train):
    jparams, jlogits, jloss, jaux, jgrads = _reference(width, train)
    tctx = _port(width, jparams)
    batch = _batch()
    params = {k: v.clone().requires_grad_(True) for k, v in tctx.module.state_dict().items()}
    fwd, bwd = tsa.fwd_launches, tsa.bwd_launches
    tlogits = tctx.apply(params, torch.from_numpy(batch["input"]), train=train)
    tloss, taux = tctx.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, train=train)
    tloss.backward()
    tgrads = convert.to_jax({k: p.grad for k, p in params.items()})
    # the CPU computes the kernels' plain versions: no launch is counted
    assert (tsa.fwd_launches, tsa.bwd_launches) == (fwd, bwd)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    assert float(taux["correct"]) == float(jaux["correct"])
    assert float(taux["count"]) == 3.0
    assert sorted(tgrads) == sorted(jgrads)
    for key, g in jgrads.items():
        np.testing.assert_allclose(tgrads[key], g, rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("width", ["d128", "bert_tiny"])
def test_attention_route_matches_jax(interpret_mode, width):
    """d_model 128 at Dh 64 takes the short-attention kernels, bert_tiny at
    Dh 16 the dense path, in both packages."""
    from distributed_learning_simulator_tpu.ops import short_attention as jsa

    w = WIDTHS[width]
    want = jsa.short_eligible(MAX_LEN, w["d_model"], w["num_heads"], 4)
    assert tsa.short_eligible(MAX_LEN, w["d_model"], w["num_heads"], 4) == want == (width == "d128")


def test_bridge_round_trip_is_exact(interpret_mode):
    """``bert_small``: the JAX init through the bridge, strictly loaded,
    and back, bit for bit; the bridge needs no rule for BERT's names."""
    jctx = _jax_ctx("bert_small")
    jparams = {k: np.asarray(v) for k, v in jax.jit(jctx.init)(jax.random.PRNGKey(1)).items()}
    assert jparams["pos_embed"].shape == (1, MAX_LEN, 256)
    tctx = _port("bert_small", jparams)
    assert tctx.module.remat_blocks == tuple(f"Layer_{i}" for i in range(4))
    back = convert.to_jax(tctx.module.state_dict())
    assert sorted(back) == sorted(jparams)
    for key, value in jparams.items():
        assert back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_factories_take_the_jax_aliases_and_kwargs():
    from distributed_learning_simulator_tpu_torch.data import create_dataset_collection
    from distributed_learning_simulator_tpu_torch.models import create_model_context

    config = tconfig.DistributedTrainingConfig(
        dataset_name="AGNews", dataset_kwargs={"max_len": 24, "train_size": 8, "val_size": 4, "test_size": 4}
    )
    dc = create_dataset_collection(config)
    for name in ("bert_base", "bert-base", "BertForSequenceClassification", "bert_small", "bert-small",
                 "bert_tiny", "bert-tiny"):
        ctx = create_model_context(name, dc, CPU, dropout_rate=0.2)
        module = ctx.module
        assert module.pos_embed.shape[1] == 24, name  # max_len defaults to the dataset's
        assert module.Layer_0.dropout.rate == 0.2, name
        assert ctx.num_classes == 4 and ctx.dataset_type == "text"
    module = create_model_context("bert_tiny", dc, CPU, max_len=40).module
    assert module.pos_embed.shape == (1, 40, 32)


# ------------------------------------------------------------ trajectory
ROUNDS = 2


def _fields(tmp_path, name, **extra):
    fields = dict(
        dataset_name="AGNews",
        model_name="bert_tiny",
        distributed_algorithm="fed_avg",
        worker_number=2,
        batch_size=16,
        round=ROUNDS,
        epoch=1,
        learning_rate=0.05,
        dataset_kwargs={"max_len": MAX_LEN, "vocab_size": VOCAB, "train_size": 64, "val_size": 16,
                        "test_size": 32},
        # flax's threefry dropout bits cannot be reproduced (R5)
        model_kwargs={"dropout_rate": 0.0},
        save_dir=str(tmp_path / name),
        log_file=str(tmp_path / f"{name}.log"),
    )
    fields.update(extra)
    return fields


def _final_params(config):
    path = os.path.join(config.save_dir, "aggregated_model", f"round_{config.round}.npz")
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def test_bert_tiny_fed_avg_trajectory_matches_jax(tmp_path):
    from distributed_learning_simulator_tpu.data import create_dataset_collection as j_create_dc
    from distributed_learning_simulator_tpu.engine.engine import ComputeEngine as JaxEngine
    from distributed_learning_simulator_tpu.engine.hyper_parameter import HyperParameter as JaxHP
    from distributed_learning_simulator_tpu.models.registry import create_model_context as j_create_model

    init = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "init"))
    jctx = j_create_model(init.model_name, j_create_dc(init), **init.model_kwargs)
    params = JaxEngine(jctx, JaxHP(), total_steps=1).init_params(0)
    npz = str(tmp_path / "init.npz")
    np.savez(npz, **{k: np.asarray(v) for k, v in params.items()})
    kwargs = {"algorithm_kwargs": {"global_model_path": npz}}
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", **kwargs))
    tc = tconfig.DistributedTrainingConfig(**_fields(tmp_path, "torch", **kwargs))
    jres = jax_train(jc)["performance"]
    tres = torch_train(tc, device="cpu")["performance"]
    assert sorted(tres) == sorted(jres) == list(range(1, ROUNDS + 1))
    for r in jres:
        np.testing.assert_allclose(tres[r]["test_loss"], jres[r]["test_loss"], rtol=1e-4)
        assert tres[r]["test_accuracy"] == jres[r]["test_accuracy"]
        assert tres[r]["test_count"] == jres[r]["test_count"] == 32.0
    jparams, tparams = _final_params(jc), _final_params(tc)
    assert sorted(tparams) == sorted(jparams)
    for key, value in jparams.items():
        np.testing.assert_allclose(tparams[key], value, rtol=1e-4, atol=1e-5, err_msg=key)


# ------------------------------------------------------------ the shipped file
SHIPPED = "large_scale/fed_avg/bert_agnews.yaml"


def test_bert_agnews_runs_one_round_at_full_width(tmp_path, monkeypatch):
    """``bert_agnews.yaml`` through the port's ``load_config`` at full
    width (``bert_base``, 110 M parameters, max_len 128, ``use_amp``,
    ``client_chunk: auto``) for one round on the CPU.  Cut: ``round`` 1,
    ``worker_number`` 16, ``random_client_number`` 2, ``batch_size`` 1,
    16 training samples, 4 validation and 4 test samples.  ``auto``
    misses the calibration (no entry has the port's key) and runs the
    default chunk of 8: two K1 chunks of ``[8, D]`` bf16 rows."""
    monkeypatch.chdir(tmp_path)
    shipped = tconfig.load_config(["--config-name", SHIPPED])
    assert shipped.model_name == "bert_base" and shipped.use_amp
    assert shipped.algorithm_kwargs["client_chunk"] == "auto"
    sizes = {"train_size": 16, "val_size": 4, "test_size": 4}
    overrides = ["++round=1", "++worker_number=16", "++algorithm_kwargs.random_client_number=2", "++batch_size=1"]
    overrides += [f"++dataset_kwargs.{k}={v}" for k, v in sizes.items()]
    config = tconfig.load_config(["--config-name", SHIPPED, *overrides])
    assert config.dataset_kwargs == {**shipped.dataset_kwargs, **sizes}
    from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa

    chunks = []
    real = wa.weighted_accum_plain
    monkeypatch.setattr(wa, "weighted_accum_plain", lambda x, w: chunks.append((tuple(x.shape), x.dtype)) or real(x, w))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        row = torch_train(config, device="cpu")["performance"][1]
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(row["test_loss"]) and 0.0 <= row["test_accuracy"] <= 1.0
    assert row["test_count"] == 4.0
    d = chunks[0][0][1]
    assert 100_000_000 < d < 120_000_000
    assert chunks == [((8, d), torch.bfloat16)] * 2
    with open(config.log_file, encoding="utf8") as f:
        assert "client_chunk: auto found NO calibration entry" in f.read()
    with open(os.path.join(config.save_dir, "server", "round_record.json"), encoding="utf8") as f:
        assert sorted(json.load(f)) == ["1"]
