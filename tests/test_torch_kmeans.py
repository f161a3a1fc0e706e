"""The port's K-Means kernel module (tpumr_torch/ops/kmeans.py) against the
JAX package's (tpumr/ops/kmeans.py), on the CPU.

On the CPU the kernel wrapper runs its plain torch version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.
Inputs come from numpy seeds and go to both packages as numpy arrays.
"""

import os

import numpy as np
import pytest
import torch

from tpumr.io.recordbatch import DenseBatch as JaxDenseBatch
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.ops import get_kernel as jax_get_kernel
from tpumr.ops.kmeans import assign_and_partials as jax_assign_and_partials
from tpumr.ops.kmeans import clear_centroid_cache as jax_clear_centroids
from tpumr.ops.kmeans import pallas_assign
from tpumr_torch.io.recordbatch import DenseBatch
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.ops import get_kernel
from tpumr_torch.ops import kmeans as tk


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("n,d,k,block_n,seed", [(100, 3, 5, 32, 1),
                                                (257, 5, 7, 2048, 0)])
def test_assign_plain_matches_pallas_interpret(n, d, k, block_n, seed):
    """Mirrors tests/test_ops.py:42-48: tpumr.ops.kmeans.pallas_assign in
    interpret mode, ids exactly equal."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    cents = rng.normal(size=(k, d)).astype(np.float32)
    want = np.asarray(pallas_assign(pts, cents, block_n=block_n,
                                    interpret=True))
    got = tk.assign_plain(_t(pts), _t(cents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor and launches
    # nothing
    launches = tk.kmeans_assign.launches
    np.testing.assert_array_equal(tk.assign(_t(pts), _t(cents)).numpy(), want)
    assert tk.kmeans_assign.launches == launches


def test_assign_and_partials_matches_jax():
    """Mirrors tests/test_ops.py:27-40 against
    tpumr.ops.kmeans.assign_and_partials(use_pallas=False): ids and counts
    equal, sums to rtol 1e-4 (f32 sums taken in another order)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(257, 5)).astype(np.float32)
    cents = rng.normal(size=(7, 5)).astype(np.float32)
    ja, js, jc = (np.asarray(x) for x in
                  jax_assign_and_partials(pts, cents, use_pallas=False))
    a, s, c = tk.assign_and_partials(_t(pts), _t(cents))
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(c.numpy(), jc)
    assert c.dtype == torch.int32 and int(c.sum()) == 257
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-4, atol=1e-6)


def test_counts_exact_past_the_f32_integer_range():
    """A split of more than 2**24 points: every count stays exact (an f32
    sum of ones stops growing at 2**24)."""
    n = 2 ** 24 + 3
    pts = torch.zeros(n, 1)
    pts[-1] = 1.0
    _a, sums, counts = tk.assign_and_partials(pts, torch.tensor([[0.], [1.]]))
    assert counts.tolist() == [n - 1, 1]
    assert sums.flatten().tolist() == [0.0, 1.0]


def test_ties_go_to_the_lower_index():
    """Exact ties (integer coordinates, so every distance is exact in f32):
    a duplicated centroid, and points halfway between two centroids. The
    JAX package (XLA path and Pallas interpret) and the port both pick the
    lower index."""
    cents = np.array([[0, 0], [2, 0], [0, 0], [0, 4]], np.float32)
    pts = np.array([[0, 0], [1, 0], [0, 2], [1, 1], [-1, 0], [0, 3]],
                   np.float32)
    want = np.array([0, 0, 0, 0, 0, 3])
    jax_xla = np.asarray(jax_assign_and_partials(pts, cents)[0])
    jax_pallas = np.asarray(pallas_assign(pts, cents, interpret=True))
    port = tk.assign_and_partials(_t(pts), _t(cents))[0].numpy()
    for got in (jax_xla, jax_pallas, port):
        np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pts, cents = torch.zeros(4, 3), torch.zeros(2, 3)
    with pytest.raises(TypeError):
        tk.kmeans_assign(pts.double(), cents)
    with pytest.raises(ValueError):
        tk.kmeans_assign(pts, torch.zeros(2, 4))
    with pytest.raises(ValueError):
        tk.kmeans_assign(pts.T, torch.zeros(2, 4))       # not contiguous
    with pytest.raises(ValueError):
        tk.kmeans_assign(pts.to("meta"), cents.to("meta"))


def _centroid_conf(conf, tmp_path, cents):
    path = tmp_path / "cents.npy"
    np.save(path, cents)
    conf.set("tpumr.kmeans.centroids", f"file://{path}")
    return conf


def test_kernel_mapper_partials_match_jax(tmp_path):
    """Mirrors tests/test_ops.py:51-70: the kmeans-assign kernel mapper's
    map_batch (launch, one copy to the host, drain) gives the JAX kernel
    mapper's records: same clusters and counts, sums to rtol 1e-4. The
    CPU-slot twin map_batch_cpu is the same numpy code in both packages,
    so its records are equal."""
    jax_clear_centroids()
    tk.clear_centroid_cache()
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(64, 4)).astype(np.float32)
    cents = rng.normal(size=(3, 4)).astype(np.float32)
    jconf = _centroid_conf(JaxJobConf(), tmp_path, cents)
    conf = _centroid_conf(JobConf(), tmp_path, cents)
    jkernel, kernel = jax_get_kernel("kmeans-assign"), get_kernel(
        "kmeans-assign")
    want = dict(jkernel.map_batch(JaxDenseBatch(pts, np.arange(64)), jconf,
                                  None))
    got = dict(kernel.map_batch(DenseBatch(_t(pts), np.arange(64)), conf,
                                None))
    assert sorted(got) == sorted(want)
    assert sum(n for _s, n in got.values()) == 64
    for cid, (s, n) in got.items():
        assert n == want[cid][1]
        np.testing.assert_allclose(s, want[cid][0], rtol=1e-4, atol=1e-6)

    want_cpu = dict(jkernel.map_batch_cpu(JaxDenseBatch(pts), jconf, None))
    got_cpu = dict(kernel.map_batch_cpu(DenseBatch(pts), conf, None))
    assert sorted(got_cpu) == sorted(want_cpu)
    for cid, (s, n) in got_cpu.items():
        np.testing.assert_array_equal(s, want_cpu[cid][0])
        assert n == want_cpu[cid][1]


def test_cpu_mapper_matches_jax(tmp_path):
    """The per-record CPU mapper (tpumr.ops.kmeans.KMeansCpuMapper) emits
    the same (cluster, (row, 1)) records."""
    from tpumr.mapred.api import OutputCollector as JaxCollector
    from tpumr.ops.kmeans import KMeansCpuMapper as JaxCpuMapper
    from tpumr_torch.mapred.api import OutputCollector

    jax_clear_centroids()
    tk.clear_centroid_cache()
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    cents = rng.normal(size=(4, 3)).astype(np.float32)
    want, got = [], []
    jm, m = JaxCpuMapper(), tk.KMeansCpuMapper()
    jm.configure(_centroid_conf(JaxJobConf(), tmp_path, cents))
    m.configure(_centroid_conf(JobConf(), tmp_path, cents))
    for i, row in enumerate(pts):
        jm.map(i, row, JaxCollector(lambda k, v: want.append((k, v))), None)
        m.map(i, row, OutputCollector(lambda k, v: got.append((k, v))), None)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, (row, one)), (_, (jrow, jone)) in zip(got, want):
        np.testing.assert_array_equal(row, jrow)
        assert one == jone == 1


def test_centroids_from_numpy_takes_read_only_state():
    """The JAX package's centroids as a read-only numpy view (how its input
    format hands arrays over) become an owned, contiguous f32 tensor."""
    cents = np.arange(12, dtype=np.float64).reshape(3, 4)
    view = np.frombuffer(cents.tobytes(), dtype=np.float64).reshape(3, 4)
    t = tk.centroids_from_numpy(view, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), cents.astype(np.float32))
    t += 1   # writable: owns its memory
    np.testing.assert_array_equal(view, cents)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,d,k,seed", [(257, 5, 7, 0), (300, 16, 16, 1),
                                        (129, 32, 64, 2), (257, 130, 131, 3)])
def test_assign_and_partials_plain_matches_jax(n, d, k, seed, use_pallas):
    """assign_and_partials_plain (the fused kernel's plain version) against
    tpumr.ops.kmeans.assign_and_partials, through its XLA path and through
    the Pallas kernel in interpret mode: ids and counts equal, sums to rtol
    1e-4 (f32 sums taken in another order). The last case lies outside the
    fused range and over the k*d <= 16,384 cap kmeans_assign once had."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    cents = rng.normal(size=(k, d)).astype(np.float32)
    ja, js, jc = (np.asarray(x) for x in jax_assign_and_partials(
        pts, cents, use_pallas=use_pallas, interpret=use_pallas))
    a, s, c = tk.assign_and_partials_plain(_t(pts), _t(cents))
    assert a.dtype == c.dtype == torch.int32 and s.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-4, atol=1e-6)
    # on the CPU the routed entry and, inside its range, the fused wrapper
    # are the plain version and launch nothing
    launches = (tk.kmeans_assign_partials.launches,
                tk.kmeans_assign.launches)
    ra, rs, rc = tk.assign_and_partials(_t(pts), _t(cents))
    assert torch.equal(ra, a) and torch.equal(rs, s) and torch.equal(rc, c)
    if d <= tk.FUSED_MAX_D and k <= tk.FUSED_MAX_K:
        fa, fs, fc = tk.kmeans_assign_partials(_t(pts), _t(cents))
        assert torch.equal(fa, a) and torch.equal(fs, s) and \
            torch.equal(fc, c)
    assert (tk.kmeans_assign_partials.launches,
            tk.kmeans_assign.launches) == launches


@pytest.mark.parametrize("device,d,k,want", [
    ("cuda", 16, 16, "fused"), ("cuda", 32, 64, "fused"),
    ("cuda", 1, 1, "fused"), ("cuda", 33, 64, "assign"),
    ("cuda", 32, 65, "assign"), ("cuda", 40, 300, "assign"),
    ("cpu", 16, 16, "plain"), ("cpu", 33, 65, "plain")])
def test_route_by_shape(device, d, k, want):
    """assign_and_partials takes the fused kernel on the card for d <= 32
    and k <= 64, kmeans_assign and the one-hot partials for any other
    shape, and the plain version for a CPU tensor."""
    assert tk.route(device, d, k) == want


#: (n, d, k) of chip_smoke.py's kmeans_assign shapes, and wider ones
_PLAN_SHAPES = [(4_000_000, 16, 16), (1_000_003, 5, 7), (1_000_000, 16, 16),
                (500_000, 40, 300), (50_000, 40, 300), (10_000, 1, 16_384),
                (250_000, 128, 1_024), (1_000_000, 64, 10),
                (20_003, 200, 70), (257, 130, 131), (1, 1, 1),
                (3, 4096, 1 << 20)]


@pytest.mark.parametrize("n,d,k", _PLAN_SHAPES)
def test_assign_plan_cuts_k_into_parts_that_cover_it(n, d, k):
    """kmeans_assign's plan for any k and d (no k*d cap): the same plan for
    the same (n, d, k, sm_count), a grid of ceil(n / bm) row blocks by
    `splits` parts, and parts that cover [0, k) in order without overlap,
    each a whole number of tiles but the last."""
    plan = tk.assign_plan(n, d, k, 132)
    assert plan == tk.assign_plan(n, d, k, 132)
    assert plan.grid == (-(-n // plan.bm), plan.splits)
    assert len(plan.parts) == plan.splits >= 1
    lo = 0
    for part_lo, part_hi in plan.parts:
        assert part_lo == lo < part_hi and part_lo % plan.bn == 0
        lo = part_hi
    assert lo == k
    assert (plan.bn, plan.bm) in tk.ASSIGN_TILES


def test_assign_plan_depends_on_the_shape_and_the_card_alone():
    """The plan takes (n, d, k, sm_count) and nothing else, and a split k
    appears only where the row blocks cannot fill the card: at chip_smoke's
    large_k shape on 132 SMs it splits, with more SMs it splits further,
    and at the second job's split it does not."""
    import inspect
    assert list(inspect.signature(tk.assign_plan).parameters) == \
        ["n", "d", "k", "sm_count"]
    large_k = tk.assign_plan(10_000, 1, 16_384, 132)
    assert large_k.splits > 1 and large_k.grid[0] * large_k.splits >= \
        tk.ASSIGN_BLOCKS_PER_SM * 132
    assert tk.assign_plan(10_000, 1, 16_384, 264).splits > large_k.splits
    assert tk.assign_plan(500_000, 40, 300, 132).splits == 1
    # k = 10 and 16 take the 16-wide tile, k = 300 five tiles of 64
    assert tk.assign_plan(1_000_000, 64, 10, 132).bn == 16
    assert tk.assign_plan(4_000_000, 16, 16, 132).bn == 16
    assert tk.assign_plan(500_000, 40, 300, 132).bn == 64
    assert tk.assign_plan(250_000, 128, 1_024, 132).bn == 128
    # the point tile stays resident while it fits, and streams past that
    assert tk.assign_plan(250_000, 128, 1_024, 132).resident
    assert not tk.assign_plan(20_003, 200, 70, 132).resident
    with pytest.raises(ValueError):
        tk.assign_plan(0, 4, 4, 132)


#: (n, d, k) of chip_smoke.py's kmeans_assign_partials shapes, the corners
#: of its range, and counts of points around a tile and past 2**31 / 512
_FUSED_PLAN_SHAPES = [(4_000_000, 16, 16), (1_000_003, 5, 7),
                      (1_000_000, 16, 16), (1_000_003, 32, 64), (1, 1, 1),
                      (1_023, 4, 64), (1_025, 8, 1), (513, 9, 33),
                      (300, 32, 64), (200_000_000, 16, 16),
                      (2 ** 31 - 1, 32, 64)]


@pytest.mark.parametrize("sms", [1, 132, 264])
@pytest.mark.parametrize("n,d,k", _FUSED_PLAN_SHAPES)
def test_fused_plan_covers_every_tile_with_bounded_walks(n, d, k, sms):
    """kmeans_assign_partials' plan: the same for the same (n, d, k,
    sm_count); the instance of the narrowest width that holds d; never more
    blocks than tiles; blocks b walking tiles b, b + grid, ... meet every
    tile exactly once, and none walks more than FUSED_MAX_TILES_PER_BLOCK;
    its shared memory fits a block, and blocks_per_sm blocks fit an SM."""
    plan = tk.fused_plan(n, d, k, sms)
    assert plan == tk.fused_plan(n, d, k, sms)
    assert plan.dp == min(w for w in (4, 8, 16, 32) if w >= d)
    assert plan.tile == tk.FUSED_TILE
    tiles = -(-n // plan.tile)
    assert 1 <= plan.grid <= tiles
    walk = -(-tiles // plan.grid)
    assert walk <= tk.FUSED_MAX_TILES_PER_BLOCK
    if tiles <= 1 << 20:
        seen = np.arange(plan.grid)[:, None] + \
            plan.grid * np.arange(walk)[None, :]
        seen = np.sort(seen[seen < tiles])
        np.testing.assert_array_equal(seen, np.arange(tiles))
    assert plan.smem == tk.fused_smem(plan.dp, k) <= tk.SMEM_PER_BLOCK
    assert 1 <= plan.blocks_per_sm <= tk.FUSED_MIN_BLOCKS[plan.dp]
    assert plan.blocks_per_sm * (plan.smem + tk.SMEM_RESERVED) <= \
        tk.SMEM_PER_SM
    assert plan.grid == min(tiles, max(plan.blocks_per_sm * sms,
                                       -(-tiles // 32)))


def test_fused_plan_depends_on_the_shape_and_the_card_alone():
    """The plan takes (n, d, k, sm_count) and nothing else. At the main
    path's split on 132 SMs: two blocks of 512-point tiles an SM (16
    assigning warps), 264 blocks. More SMs give more blocks; at d = 16 a k
    past 32 and at d = 32 any k leave room for one block an SM."""
    import inspect
    assert list(inspect.signature(tk.fused_plan).parameters) == \
        ["n", "d", "k", "sm_count"]
    main = tk.fused_plan(4_000_000, 16, 16, 132)
    assert main == tk.FusedPlan(dp=16, tile=512, blocks_per_sm=2,
                                smem=main.smem, grid=264)
    assert tk.fused_plan(4_000_000, 16, 16, 264).grid == 528
    assert tk.fused_plan(4_000_000, 16, 64, 132).blocks_per_sm == 1
    assert tk.fused_plan(1_000_003, 32, 64, 132).blocks_per_sm == 1
    # few points: one block a tile
    assert tk.fused_plan(1_000, 16, 16, 132).grid == 2
    for bad in [(0, 16, 16), (10, 0, 16), (10, 33, 16), (10, 16, 0),
                (10, 16, 65)]:
        with pytest.raises(ValueError):
            tk.fused_plan(*bad, 132)
    with pytest.raises(ValueError):
        tk.fused_plan(10, 16, 16, 0)


def test_fused_plan_is_computed_once_per_device_and_shape(monkeypatch):
    """The wrapper's plan is fused_plan on the device's SM count, cached per
    (device, n, d, k): a second launch of the same shape asks nothing of
    the card."""
    asked = []

    def sm_count(device):
        asked.append(device)
        return {0: 132, 1: 66}[device.index]

    monkeypatch.setattr(tk, "_sm_count", sm_count)
    tk._fused_plan_on.cache_clear()
    try:
        dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
        plan = tk._fused_plan_on(dev0, 4_000_000, 16, 16)
        assert plan == tk.fused_plan(4_000_000, 16, 16, 132)
        assert tk._fused_plan_on(dev0, 4_000_000, 16, 16) is plan
        assert tk._fused_plan_on(dev1, 4_000_000, 16, 16) == \
            tk.fused_plan(4_000_000, 16, 16, 66)
        assert asked == [dev0, dev1]
    finally:
        tk._fused_plan_on.cache_clear()


def test_assign_and_partials_on_cpu_takes_the_plain_version():
    """Out of the fused range too, a CPU tensor takes the plain version:
    the same results, no launch counted."""
    rng = np.random.default_rng(4)
    pts = _t(rng.normal(size=(50, 33)))
    cents = _t(rng.normal(size=(70, 33)))
    launches = (tk.kmeans_assign_partials.launches,
                tk.kmeans_assign.launches)
    got = tk.assign_and_partials(pts, cents)
    want = tk.assign_and_partials_plain(pts, cents)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (tk.kmeans_assign_partials.launches,
            tk.kmeans_assign.launches) == launches


def test_fused_wrapper_rejects_what_the_kernel_does_not_take():
    pts, cents = torch.zeros(4, 3), torch.zeros(2, 3)
    with pytest.raises(TypeError):
        tk.kmeans_assign_partials(pts.double(), cents)
    with pytest.raises(ValueError):
        tk.kmeans_assign_partials(pts[None], cents)          # rank 3
    with pytest.raises(ValueError):
        tk.kmeans_assign_partials(torch.zeros(3, 4).T, cents)  # not contiguous
    with pytest.raises(ValueError):
        tk.kmeans_assign_partials(torch.zeros(4, 33), torch.zeros(2, 33))
    with pytest.raises(ValueError):
        tk.kmeans_assign_partials(pts, torch.zeros(65, 3))
    with pytest.raises(ValueError):
        tk.kmeans_assign_partials(pts.to("meta"), cents.to("meta"))


def test_native_sources_are_every_cuda_file():
    """The one library is built from every .cu under tpumr_torch/csrc."""
    from tpumr_torch.ops import native
    csrc = os.path.join(os.path.dirname(native._PKG), "tpumr_torch", "csrc")
    want = sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                  if f.endswith(".cu"))
    assert sorted(native.SOURCES) == want


def test_native_library_is_stale_when_any_source_is_newer(tmp_path,
                                                          monkeypatch):
    from tpumr_torch.ops import native
    srcs = [tmp_path / "a.cu", tmp_path / "b.cu"]
    lib = tmp_path / "lib.so"
    for f in (*srcs, lib):
        f.write_text("")
    monkeypatch.setattr(native, "SOURCES", tuple(map(str, srcs)))
    monkeypatch.setattr(native, "LIBRARY", str(lib))
    os.utime(srcs[0], (100, 100))
    os.utime(srcs[1], (100, 100))
    os.utime(lib, (200, 200))
    assert not native.stale()
    os.utime(srcs[1], (300, 300))
    assert native.stale()
    lib.unlink()
    assert native.stale()
