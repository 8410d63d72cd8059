"""The port's costwatch (``util/costwatch.py``) against the JAX package's:
``roofline``, ``merge_ledgers``, ``normalize_cost`` and ``LEDGER_FIELDS``
equal on a grid of inputs; the card's tables matched by longest prefix,
0.0 on an unknown device and on the CPU; and ``program_cost``'s ``flops``
for a small MLP step on the CPU equal to the hand count."""

import itertools

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu.util import costwatch as jcost
from distributed_learning_simulator_tpu_torch.util import costwatch as tcost

H100 = "NVIDIA H100 80GB HBM3"


def test_ledger_fields_match_jax():
    assert tcost.LEDGER_FIELDS == jcost.LEDGER_FIELDS


GRID = list(
    itertools.product(
        (0.0, 1.0, 3.7e9, 2.2e15),  # flops
        (0.0, 1.0, 4.1e8, 9.9e12),  # bytes accessed
        (0.0, 1e-4, 2.5),  # seconds
        (0.0, 989.4e12, 197e12),  # peak FLOP/s
        (0.0, 3.35e12, 0.82e12),  # memory bytes/s
    )
)


@pytest.mark.parametrize("chunk", range(4))
def test_roofline_matches_jax(chunk):
    for args in GRID[chunk::4]:
        assert tcost.roofline(*args) == jcost.roofline(*args), args


@pytest.mark.parametrize(
    "cost",
    [
        {"flops": 12.0, "bytes accessed": 34.0},
        [{"flops": 5.0, "bytes accessed": 6.0}, {"flops": 99.0}],
        [],
        (),
        None,
        "not a dict",
        {"flops": None, "bytes accessed": 0},
        {"transcendentals": 3.0},
    ],
)
def test_normalize_cost_matches_jax(cost):
    assert tcost.normalize_cost(cost) == jcost.normalize_cost(cost)


def test_merge_ledgers_matches_jax():
    rows = [
        {"flops": 1.5, "bytes_accessed": 2.0, "argument_bytes": 3, "output_bytes": 4.0, "temp_bytes": None},
        {"flops": 10.0, "generated_code_bytes": 7.0, "extra": 99.0},
        {},
        dict.fromkeys(jcost.LEDGER_FIELDS, 0.25),
    ]
    for n in range(len(rows) + 1):
        assert tcost.merge_ledgers(rows[:n]) == jcost.merge_ledgers(rows[:n])


def test_chip_tables_match_by_longest_prefix(monkeypatch):
    assert tcost.chip_peak_flops(H100, 1) == 989.4e12
    assert tcost.chip_hbm_bandwidth(H100, 1) == 3.35e12
    assert tcost.chip_peak_flops(H100, 4) == 4 * 989.4e12
    assert tcost.chip_peak_flops(H100 + " (MIG 1g.10gb)", 1) == 989.4e12
    monkeypatch.setitem(tcost.BF16_PEAK, "NVIDIA H100", 1.0)  # a shorter prefix loses
    assert tcost.chip_peak_flops(H100, 1) == 989.4e12
    assert tcost.chip_peak_flops("NVIDIA H100 PCIe", 1) == 1.0
    for name in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", ""):
        assert tcost.chip_peak_flops(name, 1) == 0.0
        assert tcost.chip_hbm_bandwidth(name, 1) == 0.0
    # no TPU figure in the port's tables
    assert not any(key.startswith("TPU") for key in (*tcost.BF16_PEAK, *tcost.HBM_BANDWIDTH))


def test_chip_tables_read_zero_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcost.chip_peak_flops() == 0.0
    assert tcost.chip_hbm_bandwidth() == 0.0


def test_program_cost_counts_an_mlp_step():
    """A step of a 16 -> 32 -> 4 MLP on a batch of 8: forward, backward to
    both weights and the hidden activations, an SGD update.  Hand count,
    2 FLOPs a multiply-add: forward 2·8·16·32 + 2·8·32·4; backward the
    first weight's gradient 2·8·16·32 (the input takes none), the second
    layer's weight and input gradients 2·(2·8·32·4); the update and the
    elementwise ops count nothing."""
    gen = torch.Generator().manual_seed(0)
    w1 = torch.randn(32, 16, generator=gen, requires_grad=True)
    w2 = torch.randn(4, 32, generator=gen, requires_grad=True)
    x = torch.randn(8, 16, generator=gen)

    def step(w1, w2, x):
        loss = torch.relu(x @ w1.T) @ w2.T
        loss.sum().backward()
        with torch.no_grad():
            for w in (w1, w2):
                w -= 0.1 * w.grad
        return loss.detach()

    before = (w1.detach().clone(), w2.detach().clone())
    out, row = tcost.program_cost(step, (w1, w2, x))
    want = 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4 + 2 * 8 * 16 * 32 + 2 * (2 * 8 * 32 * 4)
    assert row["flops"] == want == 22528
    assert row["argument_bytes"] == (32 * 16 + 4 * 32 + 8 * 16) * 4
    assert row["output_bytes"] == 8 * 4 * 4
    assert set(row) == set(jcost.LEDGER_FIELDS)
    assert row["bytes_accessed"] == row["temp_bytes"] == row["generated_code_bytes"] == 0.0
    # the call ran once, as it would have unpriced
    w1p, w2p = before[0].clone().requires_grad_(), before[1].clone().requires_grad_()
    plain = step(w1p, w2p, x)
    assert torch.equal(out, plain) and torch.equal(w1.detach(), w1p.detach())
    np.testing.assert_array_equal(w2.detach().numpy(), w2p.detach().numpy())
    _, row = tcost.program_cost(lambda: torch.ones(3), (), cost_args=({"a": np.zeros(5, np.float64)}, [torch.ones(2)]))
    assert (row["flops"], row["argument_bytes"], row["output_bytes"]) == (0.0, 48.0, 12.0)
