"""The port's threaded FedOBD at ``second_phase_epoch: 1`` against the JAX
package's threaded run: ``fed_obd`` over NNADQ and ``fed_obd_sq`` over
QSGD, LeNet5/MNIST, 2 workers, 2 phase-1 rounds of 2 epochs and the one
tuning epoch, from one JAX init.  The port's workers train the FedOBD
session's stream and key their QSGD uploads and the server its broadcasts
with the session's draws; fed the JAX draws for those requests
(:class:`JaxSessionRandom`), the port makes the JAX threaded run's
messages.  As JAX's ``tests/test_executor_matrix.py`` holds its two
executors: round 1 within atol 1e-5, every record within 5e-3.  Past
round 1 the two packages' aggregates differ in the last bits, and the
codecs round both (ROADMAP R10: NNADQ's deterministic levels, QSGD's
stochastic ones): the elements of each aggregate beyond 1e-5 are counted
and printed.

And the K2/K3 launches of a threaded fed_obd_sq run at
``second_phase_epoch: 1`` with ``flat_payload: false``: every encode is
keyed, and keyed encodes never take the kernels, so ``chip_smoke.py``'s
protocol count is 0 and 0, on a model whose embedding an unkeyed encode
would send through K2.
"""

import os

import numpy as np
import pytest

from distributed_learning_simulator_tpu import config as jconfig
from distributed_learning_simulator_tpu.training import train as jax_train
from distributed_learning_simulator_tpu_torch import config as tconfig
from distributed_learning_simulator_tpu_torch import training

from test_torch_fed_obd import JaxSessionRandom
from test_torch_threaded import OBD_WIDTH, _Counted, _init_npz, _obd_fields, _obd_task, chip_smoke
from test_torch_threaded_methods import WORKERS, _fields

ROUNDS = 2
OBD = {"second_phase_epoch": 1, "dropout_rate": 0.5}


def _aggregates(config, keys) -> list[dict]:
    out = []
    for key in keys:
        with np.load(os.path.join(config.save_dir, "aggregated_model", f"round_{key}.npz")) as blob:
            out.append({k: blob[k] for k in blob.files})
    return out


@pytest.mark.parametrize("method", ["fed_obd", "fed_obd_sq"])
def test_threaded_obd_matches_jax_threaded(tmp_path, method):
    init = _init_npz(tmp_path / "init.npz", "LeNet5", _fields(tmp_path, "init", method), {})
    kwargs = dict(OBD, global_model_path=init)
    jc = jconfig.DistributedTrainingConfig(**_fields(tmp_path, "jax", method, algorithm_kwargs=kwargs))
    jres = jax_train(jc)["performance"]
    fields = _fields(tmp_path, "torch", method, algorithm_kwargs=kwargs)
    if method == "fed_obd_sq":
        random = JaxSessionRandom("obd", jc.seed, WORKERS)
        fields["endpoint_kwargs"] = {"worker": {"random": random}, "server": {"random": random}}
    tc = tconfig.DistributedTrainingConfig(**fields)
    tres = training.train(tc, device="cpu")["performance"]

    phases = [row["phase"] for _, row in sorted(tres.items())]
    assert phases == [row["phase"] for _, row in sorted(jres.items())]
    assert phases == ["block_dropout_rounds"] * ROUNDS + ["epoch_tune"]
    np.testing.assert_allclose(tres[1]["test_loss"], jres[1]["test_loss"], rtol=0, atol=1e-5)
    for key in jres:
        np.testing.assert_allclose(tres[key]["test_loss"], jres[key]["test_loss"], rtol=0, atol=5e-3)
        np.testing.assert_allclose(tres[key]["received_mb"], jres[key]["received_mb"], rtol=1e-6)
        np.testing.assert_allclose(tres[key]["sent_mb"], jres[key]["sent_mb"], rtol=1e-6)
    keys = sorted(jres)
    apart = []
    for got, want in zip(_aggregates(tc, keys), _aggregates(jc, keys)):
        assert sorted(got) == sorted(want)
        apart.append(sum(int((np.abs(got[k] - want[k]) > 1e-5).sum()) for k in want))
    size = sum(v.size for v in _aggregates(jc, keys[:1])[0].values())
    print(f"threaded {method}: elements beyond 1e-5 by aggregate {apart} of {size}; test loss"
          f" {[round(tres[k]['test_loss'], 6) for k in keys]} vs JAX {[round(jres[k]['test_loss'], 6) for k in keys]}")
    assert apart[0] <= 5e-4 * size  # round 1: both packages code the same deltas


def test_keyed_fed_obd_sq_launches_no_qsgd_kernel(tmp_path, monkeypatch):
    init = _init_npz(tmp_path / "init.npz", "LongContextTransformer", _obd_fields(tmp_path, "init"), OBD_WIDTH)
    counted = _Counted(monkeypatch)
    ctx = _obd_task(tmp_path, "keyed", init, second_phase_epoch=1)
    perf = training.run_task(ctx)["performance"]
    assert [row["phase"] for _, row in sorted(perf.items())] == ["block_dropout_rounds"] * 2 + ["epoch_tune"]
    assert max(t.numel() for t in ctx.model_ctx.module.state_dict().values()) >= 65536
    assert chip_smoke.expected_qsgd_launches(ctx) == (0, 0)
    assert (counted.encode, counted.decode) == (0, 0)
