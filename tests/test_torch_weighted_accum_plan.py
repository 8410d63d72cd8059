"""``ops/weighted_accum.py::plan``, the launch shape of kernel K1, on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
to its plain version there); these tests hold what decides how it runs:

* ``plan`` at the shapes the sessions launch: the variant, the grid, and a
  launch shape the C entry (``csrc/weighted_accum.cu::launch``) accepts;
* a numpy walk of the plan's tiles, with the kernel's index arithmetic,
  that reads every ``(c, i)`` of ``[C, N]`` exactly once, stores every
  ``out[i]`` exactly once, and reads nothing outside the rows' storage;
* the split variant's summation order (each row group's FMAs in row
  order, then the groups' butterfly shuffles) emulated in f32 at the
  graph sessions' shape, within the card check's tolerance of
  ``weighted_accum_plain``, and its vote sums exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_learning_simulator_tpu_torch.ops import weighted_accum as wa

#: the variants and the (vectors, rows in flight) the kernel is built for,
#: as the C entry checks them
BUILT = {"split": {(1, 8)}, "stream": {(1, 4), (2, 1), (4, 2)}, "scalar": {(4, 2)}}


def _pad(n: int) -> int:
    """The sessions' row stride: rows start on 128-byte boundaries."""
    return -(-n // 64) * 64


def c_entry_accepts(p: wa.Plan, c: int, n: int, ld: int, dtype, aligned: bool, extent: int) -> bool:
    """What ``csrc/weighted_accum.cu::launch`` checks before it launches."""
    width = 16 // (4 if dtype == torch.float32 else 2)
    vector = p.variant != "scalar"
    items = -(-n // (width if vector else 1))
    groups = 32 // p.lanes
    shape_ok = (
        1 <= c <= 2**31 - 1 and 1 <= n <= 2**31 - 1 - 1024 and ld >= 0 and 32 <= p.threads <= 256
        and p.threads % 32 == 0 and 1 <= p.lanes <= 32 and 32 % p.lanes == 0 and p.rows >= 1
        and groups * p.rows >= c and p.vectors >= 1 and (c - 1) * ld + n <= extent
    )
    grid_ok = 1 <= p.blocks <= -(-items // (p.threads // 32 * p.lanes * p.vectors))
    layout_ok = not vector or (aligned and ld % width == 0)
    padded_ok = not p.padded or (vector and ld >= items * width and (c - 1) * ld + items * width <= extent)
    variant_ok = p.vectors == 1 if p.variant == "split" else p.lanes == 32 and p.rows == c
    built = (p.vectors, p.unroll) in BUILT[p.variant]
    return (shape_ok and grid_ok and layout_ok and padded_ok and variant_ok and built
            and p.width == (width if vector else 1))


def walk(p: wa.Plan, c: int, n: int, ld: int):
    """The kernel's index arithmetic over every block, thread, tile and row:
    how often each ``(c, i)`` is read into a sum, how often each ``out[i]``
    is stored, and the largest element offset any load touches."""
    width = p.width
    items = -(-n // width)
    whole = n // width
    loaded = items if p.padded else whole
    per_tile = p.cols * p.vectors
    reads = np.zeros((c, n), np.int64)
    stores = np.zeros(n, np.int64)
    furthest = -1
    t = np.arange(p.threads)
    lane32 = t % 32
    group = lane32 // p.lanes
    ct = t // 32 * p.lanes + lane32 % p.lanes
    for block in range(p.blocks):
        tile = block
        while tile * per_tile < items:
            for j in range(p.vectors):
                item = tile * per_tile + j * p.cols + ct
                for g in np.unique(group):
                    mine = item[(group == g) & (item < items)]
                    if not mine.size:
                        continue
                    rows = range(g * p.rows, min(c, (g + 1) * p.rows))
                    for k in rows:
                        for it in mine:
                            valid = min(width, n - it * width)
                            reads[k, it * width : it * width + valid] += 1
                            span = width if it < loaded else valid
                            furthest = max(furthest, k * ld + it * width + span - 1)
                    if g == 0:
                        for it in mine:
                            stores[it * width : it * width + min(width, n - it * width)] += 1
            tile += p.blocks
    return reads, stores, furthest


#: the shapes the sessions launch: (label, dtype, C, N)
LABELLED = [
    ("vit_small chunk", torch.bfloat16, 2, 21_341_578, "stream"),
    ("densenet40 chunk", torch.float32, 5, 578_090, "stream"),
    ("sign_SGD vote", torch.bfloat16, 10, 578_090, "stream"),
    ("Shapley subset", torch.float32, 10, 578_090, "stream"),
    ("graph round", torch.float32, 50, 9_231, "split"),
]


@pytest.mark.parametrize("label,dtype,c,n,variant", LABELLED, ids=[case[0] for case in LABELLED])
def test_plan_at_the_sessions_shapes(label, dtype, c, n, variant):
    ld = _pad(n)
    p = wa.plan(c, n, ld, dtype, True)
    assert p.variant == variant
    assert p.padded == (n % p.width != 0)  # the sessions' stride pads past the ragged end
    assert p.blocks == p.tiles(n)  # a block a tile
    if variant == "split":
        assert p.blocks >= wa.SMS  # the tiles cover the SMs
    assert c_entry_accepts(p, c, n, ld, dtype, True, c * ld)


def test_plan_takes_unaligned_rows_as_scalar():
    p = wa.plan(3, 1001, 1003, torch.float32, True)
    assert p.variant == "scalar" and p.width == 1 and not p.padded
    assert c_entry_accepts(p, 3, 1001, 1003, torch.float32, True, 3 * 1003)
    # a misaligned first row takes the scalar loads too
    assert wa.plan(3, 1024, 1024, torch.float32, False).variant == "scalar"


def test_c_entry_refuses_a_plan_that_skips_a_row_group():
    p = wa.plan(50, 9231, _pad(9231), torch.float32, True)
    short = dataclasses.replace(p, rows=p.rows - 1)  # the last group's rows fall off the end
    assert (32 // short.lanes) * short.rows < 50
    assert not c_entry_accepts(short, 50, 9231, _pad(9231), torch.float32, True, 50 * _pad(9231))
    # reading the padding of a last row the storage does not hold is refused too
    assert not c_entry_accepts(p, 50, 9231, _pad(9231), torch.float32, True, 49 * _pad(9231) + 9231)
    # and a block past the last tile
    assert not c_entry_accepts(dataclasses.replace(p, blocks=p.blocks + 1), 50, 9231, _pad(9231), torch.float32,
                               True, 50 * _pad(9231))


def _walk_cases():
    """A few dozen (dtype, C, N, ld, extent) from a seed: C = 1, C above
    the row groups of a warp, N below a vector, ragged ends on padded and
    unpadded rows, unaligned strides, and both sides of STREAM_MIN_ITEMS."""
    rng = np.random.default_rng(15)
    cases = [
        (torch.float32, 1, 3, 4, None),
        (torch.float32, 1, 9231, 9280, None),
        (torch.float32, 50, 9231, 9280, None),
        (torch.float32, 50, 9231, 9232, 49 * 9232 + 9231),  # no padding after the last row
        (torch.bfloat16, 7, 1001, 1003, None),  # unaligned: scalar
        (torch.float32, 40, 2, 4, None),  # more rows than row groups, N below a vector
        (torch.bfloat16, 3, 8 * wa.STREAM_MIN_ITEMS + 5, 8 * wa.STREAM_MIN_ITEMS + 64, None),
        (torch.float32, 2, 4 * wa.STREAM_MIN_ITEMS - 1, 4 * wa.STREAM_MIN_ITEMS, None),
    ]
    while len(cases) < 32:
        dtype = (torch.float32, torch.bfloat16)[rng.integers(2)]
        width = 4 if dtype == torch.float32 else 8
        c = int(rng.choice([1, 2, 3, 5, 7, 8, 9, 33, 50, 70]))
        n = int(rng.integers(1, 3000))
        ld = int(rng.choice([n, _pad(n), n + int(rng.integers(1, 9))]))
        extent = None if rng.random() < 0.7 else (c - 1) * ld + n
        if ld % width == 0 or rng.random() < 0.3:
            cases.append((dtype, c, n, ld, extent))
    return cases


@pytest.mark.parametrize("dtype,c,n,ld,extent", _walk_cases())
def test_tile_walk_covers_every_value_once(dtype, c, n, ld, extent):
    extent = c * ld if extent is None else extent
    p = wa.plan(c, n, ld, dtype, True, extent)
    assert c_entry_accepts(p, c, n, ld, dtype, True, extent)
    # the plan's grid (a block a tile), and a grid a third its size whose
    # blocks walk several tiles
    for grid in (p, dataclasses.replace(p, blocks=max(1, p.blocks // 3))):
        reads, stores, furthest = walk(grid, c, n, ld)
        assert (reads == 1).all()
        assert (stores == 1).all()
        assert furthest < extent  # the ragged end read whole only where the storage holds it
        if p.padded:
            assert furthest < (c - 1) * ld + p.items(n) * p.width


def _fma(a: np.ndarray, b: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """f32 fused multiply-add: the product is exact in f64, one rounding."""
    return (a.astype(np.float64) * b.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


def split_order(x: np.ndarray, w: np.ndarray, p: wa.Plan) -> np.ndarray:
    """The split variant's sum in f32: each row group's FMAs in row order
    from 0, then the butterfly shuffles' pairwise adds, as group 0 takes
    them."""
    c = x.shape[0]
    groups = 32 // p.lanes
    sums = []
    for g in range(groups):
        acc = np.zeros(x.shape[1], np.float32)
        for k in range(g * p.rows, min(c, (g + 1) * p.rows)):
            acc = _fma(np.float32(w[k]), x[k], acc)
        sums.append(acc)
    offset = 1
    while offset < groups:  # lane ^ (offset * lanes): group g adds group g ^ offset
        sums = [(sums[g] + sums[g ^ offset]).astype(np.float32) for g in range(groups)]
        offset *= 2
    return sums[0]


def test_split_order_is_within_the_card_check_of_the_plain_version():
    """At the graph sessions' shape ([50, 9,231] f32, the slots' node counts
    as weights, as ``chip_smoke.py`` draws them) the split order stays
    within ``1e-6 * max|ref|`` of the plain version's client-by-client sum."""
    rng = np.random.default_rng(0)
    c, n = 50, 9231
    x = rng.normal(size=(c, n)).astype(np.float32)
    w = np.floor(rng.random(c) * 512).astype(np.float32)
    p = wa.plan(c, n, _pad(n), torch.float32, True)
    assert p.variant == "split" and 32 // p.lanes > 1
    got = split_order(x, w, p)
    ref = wa.weighted_accum_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    tol = 1e-6 * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol


def test_split_order_keeps_a_vote_exact():
    rng = np.random.default_rng(1)
    c, n = 50, 9231
    x = np.sign(rng.normal(size=(c, n))).astype(np.float32)
    w = (np.arange(c) % 4 != 3).astype(np.float32)
    p = wa.plan(c, n, _pad(n), torch.bfloat16, True)
    np.testing.assert_array_equal(split_order(x, w, p), (w[:, None] * x).sum(0))


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    before = dict(wa.route_launches)
    x = torch.randn(7, 33)
    w = torch.rand(7)
    torch.testing.assert_close(wa.weighted_accum(x, w), wa.weighted_accum_plain(x, w), rtol=0, atol=0)
    assert wa.route_launches == before
    with pytest.raises(ValueError):
        wa.weighted_accum(torch.zeros(0, 4), torch.zeros(0))
