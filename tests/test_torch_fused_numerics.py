"""The summation order of tpumr_torch/csrc/kmeans_assign_partials.cu,
emulated on the CPU against the JAX package's
tpumr.ops.kmeans.assign_and_partials.

The kernel sums without atomics and in a fixed order: block b of the plan
(kmeans.fused_plan) walks tiles b, b + grid, ...; sum thread (g, t) adds
dimension t of sub-tile g's points (s * G + g, s in order) of each tile
into its own f32 accumulator; the block adds its G accumulators in order;
a second kernel adds the blocks, each thread a strided column in order,
then a tree. The emulation walks that order in f32 and must hold
chip_smoke.py's bound: within 1e-5 of sum |x| of a float64 sum, per
cluster and dimension, on one-signed data (every coordinate 1000 + N(0, 1),
chip_smoke.py's offset shape) and on rows scaled by 10^U(-3, 3).
"""

import numpy as np
import pytest
import torch

from tpumr.ops.kmeans import assign_and_partials as jax_assign_and_partials
from tpumr_torch.ops import kmeans as tk

#: chip_smoke.py's SUMS_RTOL
SUMS_RTOL = 1e-5


def emulate_sums(points: np.ndarray, ids: np.ndarray, k: int, sms: int
                 ) -> np.ndarray:
    """The fused kernel's sums [k, d] f32 for these ids, in its order on a
    card of ``sms`` SMs."""
    n, d = points.shape
    plan = tk.fused_plan(n, d, k, sms)
    g_count = tk.FUSED_SUM_THREADS[plan.dp] // plan.dp
    tiles = -(-n // plan.tile)
    x = torch.zeros(tiles * plan.tile, d, dtype=torch.float32)
    x[:n] = torch.from_numpy(points)
    a = torch.full((tiles * plan.tile,), -1, dtype=torch.int64)
    a[:n] = torch.from_numpy(ids.astype(np.int64))
    # point s * G + g of tile i: [tile, s, g]
    x = x.view(tiles, plan.tile // g_count, g_count, d)
    a = a.view(tiles, plan.tile // g_count, g_count)
    walk = -(-tiles // plan.grid)
    acc = torch.zeros(plan.grid, g_count, k + 1, d, dtype=torch.float32)
    blocks = torch.arange(plan.grid)[:, None].expand(-1, g_count)
    subs = torch.arange(g_count)[None, :].expand(plan.grid, -1)
    for i in range(walk):
        tile = torch.arange(plan.grid) + i * plan.grid
        live = tile < tiles
        for s in range(plan.tile // g_count):
            j = a[tile[live], s]                       # [live, G]
            j = torch.where(j < 0, k, j)               # past n: a spare row
            acc.index_put_((blocks[live], subs[live], j), x[tile[live], s],
                           accumulate=True)            # one add a target
    block = acc[:, 0, :k]
    for g in range(1, g_count):
        block = block + acc[:, g, :k]
    # reduce_partials_kernel: thread t sums blocks t, t + 256, ... in
    # order, then a tree over the 256 threads
    rows = -(-plan.grid // 256)
    cols = torch.zeros(rows * 256, k, d, dtype=torch.float32)
    cols[:plan.grid] = block
    cols = cols.view(rows, 256, k, d)
    fs = cols[0]
    for r in range(1, rows):
        fs = fs + cols[r]
    width = 128
    while width:
        fs = torch.cat([fs[:width] + fs[width:2 * width], fs[2 * width:]])
        width //= 2
    return fs[0].numpy()


def _data(kind: str, n: int, d: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    pts = 1000.0 + rng.normal(size=(n, d))
    if kind == "wide":
        pts *= 10.0 ** rng.uniform(-3, 3, size=(n, 1))
    cents = rng.normal(size=(k, d))
    return pts.astype(np.float32), cents.astype(np.float32)


def _rel_err(got: np.ndarray, pts: np.ndarray, ids: np.ndarray, k: int
             ) -> float:
    want = np.zeros((k, pts.shape[1]))
    scale = np.zeros_like(want)
    np.add.at(want, ids, pts.astype(np.float64))
    np.add.at(scale, ids, np.abs(pts.astype(np.float64)))
    return float((np.abs(got - want) / np.maximum(scale, 1e-30)).max())


#: (n, d, k): the main path's width, 2 blocks of 30 tiles (a one-SM card);
#: the range's edge, 1 block of 31 tiles and a ragged last one; a ragged
#: width (instance DP = 8) with a ragged last tile
_SHAPES = [(2 * 30 * 512, 16, 16), (31 * 512 + 77, 32, 64),
           (2 * 20 * 512 + 301, 5, 7)]


@pytest.mark.parametrize("kind", ["offset", "wide"])
@pytest.mark.parametrize("n,d,k", _SHAPES)
def test_sub_tile_sums_hold_the_bound(kind, n, d, k):
    """Ids and counts from tpumr.ops.kmeans.assign_and_partials; the
    emulated kernel sums within SUMS_RTOL of sum |x| of a float64 sum over
    those ids, and so within twice that of the JAX package's f32 sums,
    which hold the bound too."""
    pts, cents = _data(kind, n, d, k, seed=d + k)
    ja, js, jc = (np.asarray(v) for v in
                  jax_assign_and_partials(pts, cents, use_pallas=False))
    assert int(jc.sum()) == n
    np.testing.assert_array_equal(np.bincount(ja, minlength=k), jc)
    got = emulate_sums(pts, ja, k, sms=1)
    assert _rel_err(got, pts, ja, k) <= SUMS_RTOL
    assert _rel_err(js, pts, ja, k) <= SUMS_RTOL
    scale = np.zeros((k, d))
    np.add.at(scale, ja, np.abs(pts.astype(np.float64)))
    assert (np.abs(got - js) <= 2 * SUMS_RTOL * scale).all()
