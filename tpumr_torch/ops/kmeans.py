"""K-Means map kernel: nearest-centroid assignment and per-cluster partial
sums on the device.

Counterpart of ``tpumr/ops/kmeans.py``. Two hand-written CUDA kernels port
its TPU kernel ``_assign_kernel`` (``pallas_assign``):

- ``tpumr_torch/csrc/kmeans_assign_partials.cu`` fuses the assignment with
  the per-cluster sums and counts that ``assign_and_partials`` takes around
  it, for d <= 32 and k <= 64 (:func:`kmeans_assign_partials`; plain
  version :func:`assign_and_partials_plain`);
- ``tpumr_torch/csrc/kmeans_assign.cu`` assigns only, for any other shape
  and any k and d (:func:`kmeans_assign`, launched as :func:`assign_plan`
  says; plain version :func:`assign_plain`), and the sums and counts are
  then a one-hot product and its column sums on the card.

:func:`assign_and_partials` picks between them by shape alone
(:func:`route`). A map task emits k small records, and the centroid
all-reduce rides the shuffle.

Iterative K-Means runs one job per round: :class:`KMeansCentroidUpdateReducer`
writes round r+1's centroid file (a path of its own per round) and puts
the new centroids on the card under that path's cache tag, so round r+1's
maps upload none (:func:`centroids_from_numpy` counts the uploads).
"""

from __future__ import annotations

import functools
from typing import Any, Iterable, NamedTuple

import numpy as np
import torch

from tpumr_torch.device import full_f32_products, select_device
from tpumr_torch.mapred.api import Mapper, Reducer
from tpumr_torch.ops import native
from tpumr_torch.ops.registry import KernelMapper, register_kernel

# Products in full f32 on the card: TF32 keeps about three decimal digits,
# which would move near-tie assignments and the partial sums away from the
# f32 reference.
full_f32_products()

#: kmeans_assign's tile instances (BN centroids, BM points): up to k = 64
#: the narrowest that holds every centroid, past it 64 or 128, whichever pads
#: k less (ties to 128)
ASSIGN_TILES = ((16, 256), (32, 256), (64, 256), (128, 128))
#: a block's point tile stays resident in shared memory up to this many
#: bytes (two blocks of 128 points at d = 128 fit on an SM with their rings)
ASSIGN_RESIDENT_BYTES = 72 * 1024
#: split k when the row blocks alone give fewer than this many blocks per SM
ASSIGN_BLOCKS_PER_SM = 4


class AssignPlan(NamedTuple):
    """How :func:`kmeans_assign` launches for one shape on one card."""
    bm: int            #: points per block
    bn: int            #: centroids per tile
    splits: int        #: parts of split k (the grid's second dimension)
    resident: bool     #: whether a block keeps its point tile in shared memory
    grid: tuple[int, int]
    parts: tuple[tuple[int, int], ...]   #: each part's centroids [lo, hi)


def assign_plan(n: int, d: int, k: int, sm_count: int) -> AssignPlan:
    """The launch of :func:`kmeans_assign` for n points of width d, k
    centroids and a card of ``sm_count`` SMs. It depends on these alone, so
    ids repeat bit for bit from launch to launch. The kernel cuts the
    centroid tiles into the same parts (``assign_tiles_kernel``)."""
    if min(n, d, k, sm_count) < 1:
        raise ValueError(f"assign_plan takes n, d, k, sm_count >= 1, got "
                         f"{n}, {d}, {k}, {sm_count}")
    bn, bm = min(((bn, bm) for bn, bm in ASSIGN_TILES if bn >= min(k, 64)),
                 key=lambda t: (-(-k // t[0]) * t[0], -t[0]))
    d4 = -(-d // 4) * 4
    stride = d4 if (d4 // 4) % 2 else d4 + 4   # odd 16-byte units
    rows, tiles = -(-n // bm), -(-k // bn)
    want = ASSIGN_BLOCKS_PER_SM * sm_count
    splits = 1 if rows >= want else min(tiles, -(-want // rows), 65535)
    parts = tuple((s * tiles // splits * bn,
                   min((s + 1) * tiles // splits * bn, k))
                  for s in range(splits))
    resident = bm * stride * 4 <= ASSIGN_RESIDENT_BYTES
    return AssignPlan(bm, bn, splits, resident, (rows, splits), parts)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def assign_plain(points: torch.Tensor, centroids: torch.Tensor
                 ) -> torch.Tensor:
    """Nearest centroid per point in plain torch: argmin over
    ``|x|² - 2x·cᵀ + |c|²`` in f32, ties to the lowest index. The same
    expression as ``tpumr/ops/kmeans.py::_assign_kernel``."""
    x2 = (points * points).sum(dim=1, keepdim=True)
    c2 = (centroids * centroids).sum(dim=1)
    d2 = x2 - 2.0 * (points @ centroids.T) + c2[None, :]
    return d2.argmin(dim=1).to(torch.int32)


def _check(points: torch.Tensor, centroids: torch.Tensor) -> None:
    if points.dim() != 2 or centroids.dim() != 2 or \
            points.shape[1] != centroids.shape[1] or centroids.shape[0] == 0:
        raise ValueError(f"points [n, d] and centroids [k>0, d] expected, got "
                         f"{tuple(points.shape)} and {tuple(centroids.shape)}")
    if points.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise TypeError(f"float32 expected, got {points.dtype} and "
                        f"{centroids.dtype}")
    if points.device != centroids.device:
        raise ValueError(f"points on {points.device}, centroids on "
                         f"{centroids.device}")
    if not (points.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("points and centroids must be contiguous")


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor
                  ) -> torch.Tensor:
    """Cluster id (int32 ``[n]``) of every point, for any k and d: the CUDA
    kernel for a CUDA tensor, :func:`assign_plain` for a CPU tensor. A CUDA
    tensor launches the kernel or raises; nothing falls back."""
    _check(points, centroids)
    if points.device.type == "cpu":
        return assign_plain(points, centroids)
    if points.device.type != "cuda":
        raise ValueError(f"kmeans_assign runs on cuda or cpu, not "
                         f"{points.device}")
    n, d = points.shape
    k = centroids.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"kmeans_assign takes n < 2**31 points, got {n}")
    dev = points.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = native.load()
    with torch.cuda.device(dev):
        plan = assign_plan(n, d, k, _sm_count(dev))
        c2 = torch.empty(k, dtype=torch.float32, device=dev)
        part_d2 = part_j = None
        if plan.splits > 1:
            part_d2 = torch.empty(plan.splits, n, dtype=torch.float32,
                                  device=dev)
            part_j = torch.empty(plan.splits, n, dtype=torch.int32,
                                 device=dev)
        rc = lib.kmeans_assign(
            points.data_ptr(), centroids.data_ptr(), c2.data_ptr(),
            None if part_d2 is None else part_d2.data_ptr(),
            None if part_j is None else part_j.data_ptr(), out.data_ptr(),
            n, d, k, plan.bn, plan.splits, int(plan.resident),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_assign launch failed: cudaError {rc}")
    kmeans_assign.launches += 1
    return out


#: kernel launches since the last reset (chip_smoke.py reads and zeroes it)
kmeans_assign.launches = 0

#: the kernel wrapper's short name
assign = kmeans_assign


#: the fused kernel's range: rows of at most this many floats ...
FUSED_MAX_D = 32
#: ... and at most this many centroids
FUSED_MAX_K = 64
#: threads (8 warps) of a block of the fused kernel, and points of a tile
#: (2 a thread)
FUSED_THREADS, FUSED_TILE = 256, 512
#: per row width DP (the kernel's instance): tiles in a block's ring (one
#: in flight, one assigned, one summed; 2 where rows of 32 floats leave no
#: room for 3) ...
FUSED_STAGES = {4: 3, 8: 3, 16: 3, 32: 2}
#: ... the threads that sum, G sub-tiles by DP dimensions (half the block at
#: DP = 16, so that two blocks fit an SM) ...
FUSED_SUM_THREADS = {4: 256, 8: 256, 16: 128, 32: 256}
#: ... and the blocks an SM must hold (``__launch_bounds__``: registers
#: allow that many); 16 assigning warps an SM where shared memory allows
FUSED_MIN_BLOCKS = {4: 2, 8: 2, 16: 2, 32: 1}
#: a block walks at most this many tiles (an accumulator takes at most
#: FUSED_TILE / G points a tile in a row)
FUSED_MAX_TILES_PER_BLOCK = 32
#: shared memory of an SM and of one block on sm_90, in bytes, and what the
#: card reserves for each resident block
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1_024


class FusedPlan(NamedTuple):
    """How :func:`kmeans_assign_partials` launches for one shape on one
    card."""
    dp: int              #: the instance's row width (d padded to 4, 8, 16, 32)
    tile: int            #: points a tile
    blocks_per_sm: int   #: blocks resident on an SM
    smem: int            #: bytes of shared memory a block takes
    grid: int            #: blocks, the partials' second dimension


def fused_smem(dp: int, k: int) -> int:
    """Bytes of shared memory of a fused block (``smem_floats`` in the
    kernel): the ring, the accumulators [k][G][dp], two tiles of ids, the
    padded centroids, their norms and each warp's counts."""
    g = FUSED_SUM_THREADS[dp] // dp
    warps = FUSED_THREADS // 32
    return 4 * (FUSED_STAGES[dp] * FUSED_TILE * dp + k * g * dp
                + 2 * FUSED_TILE + k * dp + k + warps * k)


def fused_plan(n: int, d: int, k: int, sm_count: int) -> FusedPlan:
    """The launch of :func:`kmeans_assign_partials` for n points of width
    d, k centroids and a card of ``sm_count`` SMs. It depends on these
    alone, so the partials, and the sums, repeat bit for bit from launch to
    launch. As many blocks as the card holds at once (up to the instance's
    ``FUSED_MIN_BLOCKS`` an SM), more only so that none walks more than
    ``FUSED_MAX_TILES_PER_BLOCK`` tiles, and never more than there are
    tiles. The kernel refuses any other plan."""
    if min(n, d, k, sm_count) < 1 or d > FUSED_MAX_D or k > FUSED_MAX_K:
        raise ValueError(f"fused_plan takes n, sm_count >= 1, 1 <= d <= "
                         f"{FUSED_MAX_D} and 1 <= k <= {FUSED_MAX_K}, got "
                         f"{n}, {d}, {k}, {sm_count}")
    dp = min(w for w in FUSED_STAGES if w >= d)
    tile = FUSED_TILE
    smem = fused_smem(dp, k)
    per_sm = min(FUSED_MIN_BLOCKS[dp], SMEM_PER_SM // (smem + SMEM_RESERVED))
    tiles = -(-n // tile)
    grid = min(tiles, max(per_sm * sm_count,
                          -(-tiles // FUSED_MAX_TILES_PER_BLOCK)))
    return FusedPlan(dp, tile, per_sm, smem, grid)


@functools.lru_cache(maxsize=256)
def _fused_plan_on(device: torch.device, n: int, d: int, k: int
                   ) -> FusedPlan:
    """:func:`fused_plan` on ``device``, computed once per (device, n, d,
    k)."""
    return fused_plan(n, d, k, _sm_count(device))


def onehot_partials(points: torch.Tensor, a: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums [k, d] f32 and counts [k] int32 of ``points`` under
    the ids ``a``: one f32 product ``one_hotᵀ @ points`` and the one-hot's
    column sums, as ``tpumr.ops.kmeans.assign_and_partials`` takes them.
    Both come out the same from run to run (no float atomics), and neither
    waits for the device (``torch.bincount`` on a CUDA tensor reads its
    input's min and max on the host)."""
    n = points.shape[0]
    onehot = torch.zeros(n, k, dtype=torch.float32, device=points.device)
    onehot.scatter_(1, a.long()[:, None], 1.0)
    sums = onehot.T @ points
    # exact in any order: every partial sum is an integer no larger than
    # n, and f32 holds every integer up to 2**24 (float64 beyond)
    acc = torch.float32 if n <= 2 ** 24 else torch.float64
    counts = onehot.sum(dim=0, dtype=acc).to(torch.int32)
    return sums, counts


def assign_and_partials_plain(points: torch.Tensor, centroids: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(ids [n] int32, sums [k, d] f32, counts [k] int32) in plain torch:
    :func:`assign_plain` and the one-hot partials. The plain version of
    :func:`kmeans_assign_partials`."""
    a = assign_plain(points, centroids)
    return (a, *onehot_partials(points, a, centroids.shape[0]))


def kmeans_assign_partials(points: torch.Tensor, centroids: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(ids [n] int32, sums [k, d] f32, counts [k] int32) for d <= 32 and
    k <= 64: the fused CUDA kernel for a CUDA tensor,
    :func:`assign_and_partials_plain` for a CPU tensor. Raises outside that
    range on either device. The sums are the same bits from launch to
    launch. A CUDA tensor launches the kernel or raises; nothing falls
    back."""
    _check(points, centroids)
    n, d = points.shape
    k = centroids.shape[0]
    if d > FUSED_MAX_D or k > FUSED_MAX_K:
        raise ValueError(f"kmeans_assign_partials takes d <= {FUSED_MAX_D} "
                         f"and k <= {FUSED_MAX_K}, got d={d}, k={k}")
    if points.device.type == "cpu":
        return assign_and_partials_plain(points, centroids)
    if points.device.type != "cuda":
        raise ValueError(f"kmeans_assign_partials runs on cuda or cpu, not "
                         f"{points.device}")
    if n >= 2 ** 31:
        raise ValueError(f"kmeans_assign_partials takes n < 2**31 points, "
                         f"got {n}")
    dev = points.device
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return (ids, torch.zeros(k, d, dtype=torch.float32, device=dev),
                torch.zeros(k, dtype=torch.int32, device=dev))
    lib = native.load()
    # the grid, and so the partials' second dimension, is fixed by the shape
    # and the card: the sums repeat bit for bit
    plan = _fused_plan_on(dev, n, d, k)
    # one allocation: the sums, the counts (int32 in f32's place), then the
    # partials the kernel sums them from
    out = torch.empty((k * d + k) * (1 + plan.grid), dtype=torch.float32,
                      device=dev)
    sums = out[:k * d].view(k, d)
    counts = out[k * d:k * d + k].view(torch.int32)
    args = (points.data_ptr(), centroids.data_ptr(), ids.data_ptr(),
            out.data_ptr() + 4 * (k * d + k), sums.data_ptr(),
            counts.data_ptr(), n, d, k, plan.tile, plan.grid, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if torch.cuda.current_device() == dev.index:
        rc = lib.kmeans_assign_partials(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.kmeans_assign_partials(*args)
    if rc != 0:
        raise RuntimeError(f"kmeans_assign_partials launch failed: "
                           f"cudaError {rc}")
    kmeans_assign_partials.launches += 1
    return ids, sums, counts


#: kernel launches since the last reset (chip_smoke.py reads and zeroes it)
kmeans_assign_partials.launches = 0


def route(device_type: str, d: int, k: int) -> str:
    """How :func:`assign_and_partials` computes on a device of this type at
    row width ``d`` with ``k`` centroids, by shape alone: ``"plain"`` on the
    CPU, ``"fused"`` (:func:`kmeans_assign_partials`) on the card for
    d <= 32 and k <= 64, else ``"assign"`` (:func:`kmeans_assign` and the
    one-hot partials)."""
    if device_type == "cpu":
        return "plain"
    if d <= FUSED_MAX_D and k <= FUSED_MAX_K:
        return "fused"
    return "assign"


def assign_and_partials(points: torch.Tensor, centroids: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(assignments [n] int32, partial sums [k, d] f32, counts [k] int32).

    Counterpart of ``tpumr.ops.kmeans.assign_and_partials``, routed by
    :func:`route`. Every route gives the same bits from run to run (no
    float atomics), so a job's centroids are byte-identical across rounds,
    and none waits for the device, so a window of launches costs one
    synchronisation."""
    points = points.to(torch.float32).contiguous()
    centroids = centroids.to(torch.float32).contiguous()
    how = route(points.device.type, points.shape[1], centroids.shape[0])
    if how == "plain":
        return assign_and_partials_plain(points, centroids)
    if how == "fused":
        return kmeans_assign_partials(points, centroids)
    a = kmeans_assign(points, centroids)
    return (a, *onehot_partials(points, a, centroids.shape[0]))


def _f32_tensor(arr: np.ndarray, device: "torch.device | str"
                ) -> torch.Tensor:
    host = np.array(arr, dtype=np.float32, order="C")   # owned, writable
    return torch.from_numpy(host).to(device)


def centroids_from_numpy(arr: np.ndarray, device: "torch.device | str"
                         ) -> torch.Tensor:
    """The JAX package's centroids (a numpy array, as its ``.npy`` files
    hold them) as the port's contiguous f32 tensor on ``device``: a map
    task's upload of a centroid file, counted."""
    centroids_from_numpy.uploads += 1
    return _f32_tensor(arr, device)


#: map-side centroid uploads since the last reset (chip_smoke.py reads and
#: zeroes it, as it does the launch counts)
centroids_from_numpy.uploads = 0


# ----------------------------------------------------------------- mapper


#: path -> ((length, mtime) of the file read, centroids)
_centroid_cache: "dict[str, tuple[tuple, np.ndarray]]" = {}

#: host-cache bound: one k×d array per centroid file
_CENTROID_CACHE_CAP = 8


def _centroid_file(conf: Any) -> tuple[str, tuple]:
    from tpumr_torch.ops.devcache import file_stamp
    path = conf.get("tpumr.kmeans.centroids")
    if not path:
        raise ValueError("tpumr.kmeans.centroids not set (path to .npy)")
    return path, file_stamp(conf, path)


def _load_centroids(conf: Any) -> np.ndarray:
    from tpumr_torch.fs.filesystem import FileSystem
    from tpumr_torch.mapred.input_formats import load_dense
    path, stamp = _centroid_file(conf)
    cached = _centroid_cache.get(path)
    if cached is None or cached[0] != stamp:
        _centroid_cache.pop(path, None)
        while len(_centroid_cache) >= _CENTROID_CACHE_CAP:
            _centroid_cache.pop(next(iter(_centroid_cache)))
        cached = _centroid_cache[path] = (stamp, load_dense(
            FileSystem.get(path, conf), path).astype(np.float32))
    return cached[1]


def clear_centroid_cache() -> None:
    """Drop the host and device copies of every centroid file, to free
    them: a rewritten file is read anew without a clear, since both caches
    check its length and mtime. Rounds that version their centroid path
    (``cents-r{round}.npy``) call :func:`clear_pipeline_caches` once at
    the end."""
    from tpumr_torch.ops.devcache import clear_device_cache
    _centroid_cache.clear()
    clear_device_cache("kmeans-centroids:")


def clear_pipeline_caches() -> None:
    """Teardown of versioned rounds: one sweep of every round's centroid
    entries, host and device. During the rounds nothing is cleared: each
    round's centroids have a tag of their own, and the update reducer
    pre-seeds the next round's. The same sweep as
    :func:`clear_centroid_cache`; the name says when to call it (once, at
    the end, not once per round)."""
    clear_centroid_cache()


def _device_centroids(conf: Any, device: torch.device) -> torch.Tensor:
    """The centroids on ``device``, uploaded once per (file, device) while
    the file's length and mtime stay the same. A hit (a pre-seeded round
    included) reads no more than the file's status."""
    from tpumr_torch.ops.devcache import device_cached
    path, stamp = _centroid_file(conf)
    return device_cached(
        f"kmeans-centroids:{path}", device,
        lambda: centroids_from_numpy(_load_centroids(conf), device), conf,
        stamp=stamp)


def assign_and_partials_numpy(points: np.ndarray, centroids: np.ndarray,
                              chunk: int = 1 << 16
                              ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized host twin of :func:`assign_and_partials` for CPU map
    slots (a copy of ``tpumr.ops.kmeans.assign_and_partials_numpy``).
    Returns (sums [k,d] f32, counts [k] i64)."""
    points = np.asarray(points, np.float32)
    centroids = np.asarray(centroids, np.float32)
    k, d = centroids.shape
    c2 = np.einsum("kd,kd->k", centroids, centroids)
    sums = np.zeros((k, d), np.float32)
    counts = np.zeros(k, np.int64)
    for lo in range(0, points.shape[0], chunk):
        block = points[lo:lo + chunk]
        # |x|² is constant per row — argmin doesn't need it
        d2 = c2[None, :] - 2.0 * (block @ centroids.T)
        assign = np.argmin(d2, axis=1)
        counts += np.bincount(assign, minlength=k)
        for j in range(d):
            sums[:, j] += np.bincount(assign, weights=block[:, j],
                                      minlength=k)
    return sums, counts


class KMeansCpuMapper(Mapper):
    """Per-record CPU mapper for the same job: nearest centroid in numpy
    (a copy of ``tpumr.ops.kmeans.KMeansCpuMapper``)."""

    def configure(self, conf: Any) -> None:
        self._centroids = _load_centroids(conf)

    def map(self, key, row, output, reporter):
        c = self._centroids
        d2 = ((c - np.asarray(row)[None, :]) ** 2).sum(axis=1)
        cid = int(np.argmin(d2))
        output.collect(cid, (np.asarray(row, np.float32), 1))


class CentroidReducer(Reducer):
    """Averages (partial_sum, count) pairs into the new centroid, in
    float64 (a copy of ``tpumr.examples.basic.CentroidReducer``)."""

    def reduce(self, key, values, output, reporter):
        total, n = None, 0
        for s, c in values:
            s = np.asarray(s, dtype=np.float64)
            total = s if total is None else total + s
            n += int(c)
        output.collect(key, (total / max(1, n)).tolist())


#: the convergence counter of a round: the total centroid movement, in
#: thousandths (counters are integers)
SHIFT_COUNTER_GROUP = "KMeans"
SHIFT_COUNTER = "CENTROID_SHIFT_MILLI"


class KMeansCentroidUpdateReducer(Reducer):
    """The reducer that closes a round of iterative K-Means (a copy of
    ``tpumr.ops.kmeans.KMeansCentroidUpdateReducer``). It averages the
    maps' (partial_sum, count) records in float64 and emits (cid, centroid)
    as :class:`CentroidReducer` does; on ``close`` it writes the new
    centroids as the next round's ``.npy`` (``tpumr.kmeans.centroids.out``,
    by write-then-rename), adds the centroid shift to
    ``KMeans/CENTROID_SHIFT_MILLI``, and puts the new centroids on the card
    under the next round's tag, so that round's maps find them there.
    Clusters without points keep their centroid. Needs
    ``mapred.reduce.tasks=1``."""

    #: pre-seeds of a next round's centroids since the last reset
    #: (chip_smoke.py reads it)
    preseeds = 0

    def __init__(self) -> None:
        self._sums: "dict[int, np.ndarray]" = {}
        self._counts: "dict[int, int]" = {}
        self._conf: Any = None
        self._reporter: Any = None

    def configure(self, conf: Any) -> None:
        self._conf = conf
        if conf.get_int("mapred.reduce.tasks", 1) != 1:
            raise ValueError("KMeansCentroidUpdateReducer needs "
                             "mapred.reduce.tasks=1: the centroid update "
                             "must see every cluster")

    def reduce(self, key, values, output, reporter):
        self._reporter = reporter
        total, n = None, 0
        for s, c in values:
            s = np.asarray(s, dtype=np.float64)
            total = s if total is None else total + s
            n += int(c)
        cid = int(key)
        self._sums[cid] = total
        self._counts[cid] = n
        output.collect(cid, (total / max(1, n)).tolist())

    def abort(self) -> None:
        """A failed attempt: a partly fed reducer publishes nothing."""
        self._sums.clear()
        self._counts.clear()

    def close(self) -> None:
        conf = self._conf
        out_path = conf.get("tpumr.kmeans.centroids.out") if conf else None
        if not out_path:
            return   # not iterative: the output records are the result
        import io

        from tpumr_torch.fs.filesystem import FileSystem
        prev = _load_centroids(conf)
        new = prev.copy()
        for cid, total in self._sums.items():
            if 0 <= cid < new.shape[0] and self._counts[cid] > 0:
                new[cid] = (total / self._counts[cid]).astype(np.float32)
        # write-then-rename: no reader ever sees a partly written file
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(new))
        fs = FileSystem.get(out_path, conf)
        tmp = (f"{out_path}._"
               f"{conf.get('tpumr.task.attempt.id') or 'local'}.tmp")
        with fs.create(tmp) as f:
            f.write(buf.getvalue())
        if not fs.rename(tmp, out_path):
            # a filesystem that refuses an existing destination keeps the
            # first writer's file (the bytes are the same); the temp file
            # must not linger, and failing to delete it fails nothing
            try:
                fs.delete(tmp)
            except OSError:
                pass
        shift = float(np.abs(new - prev).sum())
        if self._reporter is not None:
            self._reporter.incr_counter(SHIFT_COUNTER_GROUP, SHIFT_COUNTER,
                                        int(round(shift * 1000)))
        if not fs.exists(out_path):
            return   # a refused rename left no file to pre-seed for
        # the pre-seed, on the device the maps run on (their lookup key is
        # (tag, str(points.device)), "cuda:0" on the card), stamped with
        # the file's length and mtime as the maps will find them: a failure
        # here is a fault on the device and fails the attempt
        from tpumr_torch.ops.devcache import device_cached, file_stamp
        device = select_device(conf, 0)
        device_cached(f"kmeans-centroids:{out_path}", device,
                      lambda: self._preseed(new, device), conf,
                      stamp=file_stamp(conf, out_path))

    @staticmethod
    def _preseed(new: np.ndarray, device: torch.device) -> torch.Tensor:
        KMeansCentroidUpdateReducer.preseeds += 1
        return _f32_tensor(new, device)


class KMeansAssignKernel(KernelMapper):
    name = "kmeans-assign"
    cpu_mapper_class = KMeansCpuMapper

    def map_batch_launch(self, batch, conf, task):
        """Enqueue assign + partials on the batch's device; return the
        [k,d] sums and [k] counts as device tensors. The runner fetches a
        whole window of tasks' outputs in one copy."""
        points = batch.values
        centroids = _device_centroids(conf, points.device)
        _assign, sums, counts = assign_and_partials(points, centroids)
        return (sums, counts)

    def map_batch_drain(self, fetched, conf, task) -> Iterable[tuple]:
        sums, counts = fetched
        for cid in range(sums.shape[0]):
            if counts[cid] > 0:
                yield int(cid), (sums[cid], int(counts[cid]))

    def map_batch_cpu(self, batch, conf, task) -> Iterable[tuple]:
        """CPU-slot path on a host numpy batch: the same pre-aggregated
        records as the device path."""
        centroids = _load_centroids(conf)
        sums, counts = assign_and_partials_numpy(np.asarray(batch.values),
                                                 centroids)
        for cid in range(centroids.shape[0]):
            if counts[cid] > 0:
                yield int(cid), (sums[cid], int(counts[cid]))


register_kernel(KMeansAssignKernel())
