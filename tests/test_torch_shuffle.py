"""The port's shuffle copy phase (tpumr_torch.mapred.shuffle_copier), its
merges (tpumr_torch.io.ifile's raw-key fast path and in-memory merge) and
its serving side (tpumr_torch.mapred.tasktracker.serve_chunk over
tpumr_torch.io.fdcache.FdCache, tpumr_torch.io.compress.wire_compress).

Oracles: tests/test_shuffle_copier.py (the RAM manager, parallel and
sequential copies, chunked transfers, disk spills, the budget, retries),
tests/test_merge_engine.py (TestRawFastPath, TestBackgroundMerge: the
merge manager freeing budget during the copy, its combiner, the disk
merges), tests/test_shuffle_wire.py (TestSpillFdCache, wire compression
only where it pays), each case run on the port; and the JAX package's own
functions on the same inputs for the bytes: ifile.merge_sorted and
merge_sorted_inmem, tasktracker.serve_chunk, and a whole ShuffleCopier copy
merged, which must give the same records in the same order. Last, the host
shuffle of a small TeraSort on the port's MiniMRCluster (the cluster_shuffle
phase of chip_smoke.py, cut to 4,000 records) against the port's
LocalJobRunner, once within the default budget and once with a budget small
enough that segments go to disk and merge in the background. Every thread
a copier starts is joined before its test ends.
"""

import io
import os
import threading
import time

import numpy as np
import pytest

import tpumr.io.ifile as jax_ifile
import tpumr.mapred.jobconf as jax_jobconf
import tpumr.mapred.shuffle_copier as jax_copier
import tpumr.mapred.tasktracker as jax_tt
from tpumr.io.fdcache import FdCache as JaxFdCache
from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.io import ifile
from tpumr_torch.io.compress import WIRE_MIN_BYTES, wire_compress
from tpumr_torch.io.fdcache import FdCache
from tpumr_torch.mapred.api import RawComparator, Reporter
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.shuffle_copier import (DiskSegment, MemorySegment,
                                               ShuffleCopier,
                                               ShuffleMergeManager,
                                               ShuffleRamManager)
from tpumr_torch.mapred.tasktracker import serve_chunk


def make_spill(records, codec="zlib", partitions=1):
    """One spill file, every record in partition 0 (the port's Writer,
    whose bytes are the JAX package's)."""
    buf = io.BytesIO()
    w = ifile.Writer(buf, codec=codec)
    for p in range(partitions):
        w.start_partition()
        if p == 0:
            for k, v in records:
                w.append_raw(k, v)
        w.end_partition()
    return buf.getvalue(), w.close()


class SpillChunkSource:
    """A chunk source over spill files in memory, with the runner's
    ``get_map_output_chunk`` contract (tests/test_shuffle_copier.py's),
    counting calls and the fetches in flight."""

    def __init__(self, spills, chunk_cap=1 << 20, delay_s=0.01):
        self.spills = spills
        self.chunk_bytes = chunk_cap
        self.delay_s = delay_s
        self.calls = 0
        self.in_flight = 0
        self.max_in_flight = 0
        self.fail_first_for = set()
        self.truncate = False
        self._failed = set()
        self._lock = threading.Lock()

    def __call__(self, map_index, partition, offset):
        with self._lock:
            self.calls += 1
            self.in_flight += 1
            self.max_in_flight = max(self.max_in_flight, self.in_flight)
            if map_index in self.fail_first_for \
                    and map_index not in self._failed:
                self._failed.add(map_index)
                self.in_flight -= 1
                raise ConnectionError("synthetic fetch failure")
        try:
            time.sleep(self.delay_s)   # hold the slot: overlap shows
            data, index = self.spills[map_index]
            off, raw_len, part_len = index["partitions"][partition]
            payload = data[off + 4: off + part_len]
            if self.truncate and offset > 0:
                payload = payload[:offset]   # the stream stops short
            return {"data": payload[offset: offset + self.chunk_bytes],
                    "total": part_len - 4, "raw": raw_len,
                    "codec": index.get("codec", "none")}
        finally:
            with self._lock:
                self.in_flight -= 1


def records_for(n, tag=b"m", dup_every=0):
    """n sorted records; with ``dup_every``, runs of equal keys."""
    return [(b"%s-%06d" % (tag, i // dup_every if dup_every else i),
             b"v%d" % i) for i in range(n)]


def conf_with(**kv):
    """A job conf ordering keys as raw bytes (the test records' keys are
    not serialized values), with ``kv`` set."""
    conf = JobConf()
    conf.set_output_key_comparator_class(RawComparator)
    for k, v in kv.items():
        conf.set(k, v)
    return conf


def _thread_names():
    return {t.name for t in threading.enumerate()
            if t.name.startswith("shuffle-")}


@pytest.fixture
def no_leaked_threads():
    yield
    deadline = time.monotonic() + 5
    while _thread_names():
        assert time.monotonic() < deadline, _thread_names()
        time.sleep(0.01)


# --------------------------------------------------------- RAM manager


def test_ram_manager_reserve_and_release():
    """TestRamManager::test_reserve_release."""
    ram = ShuffleRamManager(1000, max_single_frac=0.5)
    assert ram.try_reserve(400)
    assert ram.try_reserve(500)
    assert not ram.try_reserve(200)   # the budget is full
    ram.release(400)
    assert ram.try_reserve(200)
    assert ram.used == 700


def test_ram_manager_refuses_an_oversized_segment():
    """TestRamManager::test_oversized_segment_refused, and the bounded
    wait that ends at once when no merge may free budget."""
    ram = ShuffleRamManager(1000, max_single_frac=0.25)
    assert not ram.try_reserve(251)
    assert ram.try_reserve(250)
    assert not ram.reserve_wait(251, lambda: True, 1.0)
    assert ram.try_reserve(250) and ram.try_reserve(250)
    assert ram.try_reserve(250)
    t = time.monotonic()
    assert not ram.reserve_wait(10, lambda: False, 5.0)
    assert time.monotonic() - t < 1.0


# ------------------------------------------------------------- copier


@pytest.mark.parametrize("copies", [1, 4])
def test_parallel_copies_honoured(tmp_path, copies, no_leaked_threads):
    """test_parallel_copies_honored and test_sequential_when_one_copy."""
    spills = [make_spill(records_for(200, b"m%d" % i)) for i in range(8)]
    src = SpillChunkSource(spills)
    copier = ShuffleCopier(
        conf_with(**{"tpumr.shuffle.parallel.copies": copies}), src, 8, 0,
        str(tmp_path))
    segs = copier.copy_all()
    assert copier.parallel == copies
    if copies == 1:
        assert src.max_in_flight == 1
    else:
        assert src.max_in_flight > 1
    merged = list(ifile.merge_sorted(segs, lambda k: k))
    assert merged == sorted(r for i in range(8)
                            for r in records_for(200, b"m%d" % i))
    for s in segs:
        s.close()


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_chunked_transfer_at_tiny_chunks(tmp_path, codec):
    """test_chunked_transfer: a segment arrives in many chunks."""
    recs = records_for(5000)
    src = SpillChunkSource([make_spill(recs, codec=codec)], chunk_cap=1024,
                           delay_s=0)
    segs = ShuffleCopier(conf_with(), src, 1, 0, str(tmp_path)).copy_all()
    assert src.calls > 10
    assert list(segs[0]) == recs


def test_truncated_stream_raises(tmp_path):
    """A stream that ends before its announced total fails the fetch,
    and the copy phase raises at ``tpumr.shuffle.fetch.max.failures``
    (tests/test_shuffle_copier.py::TestChunkedSegmentIO::
    test_truncated_stream_raises, at the copier)."""
    src = SpillChunkSource([make_spill(records_for(3000), codec="none")],
                           chunk_cap=1024, delay_s=0)
    src.truncate = True
    conf = conf_with(**{"tpumr.shuffle.fetch.max.failures": 2,
                        "tpumr.shuffle.copy.backoff.ms": 1})
    with pytest.raises(EOFError, match="at [0-9]+/[0-9]+ for map 0"):
        ShuffleCopier(conf, src, 1, 0, str(tmp_path)).copy_all()
    assert os.listdir(tmp_path) == []   # no half-written spill left


def test_oversized_segment_goes_to_disk(tmp_path):
    """test_oversized_segment_spills_to_disk."""
    big, small = records_for(20000), records_for(10, b"s")
    src = SpillChunkSource([make_spill(big), make_spill(small)])
    copier = ShuffleCopier(conf_with(**{"tpumr.shuffle.ram.mb": 0.1}), src,
                           2, 0, str(tmp_path))
    segs = copier.copy_all()
    assert copier.spilled_to_disk == 1 and copier.copied_in_memory == 1
    disk = [s for s in segs if isinstance(s, DiskSegment)]
    mem = [s for s in segs if isinstance(s, MemorySegment)]
    assert list(disk[0]) == big and list(mem[0]) == small
    path = disk[0].path
    assert os.path.exists(path)
    for s in segs:
        s.close()
    assert not os.path.exists(path)
    assert copier.ram.used == 0


def test_budget_never_exceeded(tmp_path, no_leaked_threads):
    """test_ram_budget_never_exceeded, with the peak watched at every
    reservation and the background merger freeing room."""
    spills = [make_spill(records_for(3000, b"m%d" % i)) for i in range(10)]
    src = SpillChunkSource(spills)
    copier = ShuffleCopier(conf_with(**{"tpumr.shuffle.ram.mb": 0.5}),
                           src, 10, 0, str(tmp_path))
    peak = [0]
    real_try = copier.ram.try_reserve

    def watched(n):
        ok = real_try(n)
        peak[0] = max(peak[0], copier.ram.used)
        return ok

    copier.ram.try_reserve = watched
    segs = copier.copy_all()
    assert 0 < peak[0] <= copier.ram.budget
    assert copier.copied_in_memory >= 1
    assert sum(1 for s in segs for _ in s) == 10 * 3000
    for s in segs:
        s.close()
    assert copier.ram.used == 0


def test_transient_failure_recovered_and_permanent_raises(tmp_path):
    """test_retry_recovers_transient_failure and
    test_permanent_failure_raises."""
    spills = [make_spill(records_for(100, b"m%d" % i)) for i in range(3)]
    src = SpillChunkSource(spills)
    src.fail_first_for = {1}
    conf = conf_with(**{"tpumr.shuffle.copy.backoff.ms": 1})
    assert len(ShuffleCopier(conf, src, 3, 0,
                             str(tmp_path)).copy_all()) == 3

    class DeadSource:
        chunk_bytes = 1 << 20

        def __call__(self, m, p, o):
            raise ConnectionError("gone")

    conf = conf_with(**{"tpumr.shuffle.fetch.max.failures": 2,
                        "tpumr.shuffle.copy.backoff.ms": 1})
    copier = ShuffleCopier(conf, DeadSource(), 1, 0, str(tmp_path))
    with pytest.raises(ConnectionError, match="gone"):
        copier.copy_all()
    assert copier.fetch_failures == 2


def test_copier_bookkeeping_holds_under_thread_pressure(tmp_path,
                                                       no_leaked_threads):
    """More fetchers than cores over many small maps, with a tiny switch
    interval, background merges running and every eighth segment larger
    than one segment's share of the budget (so on disk): every map lands
    exactly once (memory plus disk counts equal the maps), the counters
    agree, and closing every segment gives the whole budget back."""
    import sys
    sizes = [400 if i % 8 == 0 else 60 + 13 * (i % 5) for i in range(48)]
    spills = [make_spill(records_for(n, b"m%02d" % i))
              for i, n in enumerate(sizes)]
    reporter = Reporter()
    copier = ShuffleCopier(
        conf_with(**{"tpumr.shuffle.parallel.copies": 2 * os.cpu_count(),
                     "tpumr.shuffle.ram.mb": 0.02}),
        SpillChunkSource(spills, chunk_cap=256, delay_s=0), 48, 0,
        str(tmp_path), reporter)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        segs = copier.copy_all()
    finally:
        sys.setswitchinterval(old)
    g = TaskCounter.FRAMEWORK_GROUP
    mem = reporter.counters.value(g, TaskCounter.REDUCE_SHUFFLE_SEGMENTS_MEM)
    disk = reporter.counters.value(g,
                                   TaskCounter.REDUCE_SHUFFLE_SEGMENTS_DISK)
    assert mem + disk == 48 and mem > 0 and disk >= 6
    assert (copier.copied_in_memory, copier.spilled_to_disk) == (mem, disk)
    assert sum(1 for s in segs for _ in s) == sum(sizes)
    for s in segs:
        s.close()
    assert copier.ram.used == 0


# ---------------------------------------------------- background merges


class SumCombiner:
    """A combiner summing the int values of a key."""

    def configure(self, conf):
        pass

    def reduce(self, key, values, output, reporter):
        output.collect(key, sum(values))

    def close(self):
        pass


def _int_spills(n_maps, n_keys):
    from tpumr_torch.io.writable import serialize
    spills = []
    for m in range(n_maps):
        recs = sorted((serialize(f"k{k:05d}"), serialize(m + 1))
                      for k in range(n_keys))
        spills.append(make_spill(recs))
    return spills


def test_background_merge_releases_budget_during_the_copy(
        tmp_path, no_leaked_threads):
    """TestBackgroundMerge::test_wide_shuffle_merges_in_memory_and_
    releases_budget: memory segments past the merge threshold are merged
    into runs during the copy, the budget is free when the copy ends, and
    the records are the flat merge's."""
    spills = [make_spill(records_for(800, b"m%02d" % i, dup_every=3))
              for i in range(12)]
    src = SpillChunkSource(spills, delay_s=0.005)
    reporter = Reporter()
    copier = ShuffleCopier(conf_with(**{"tpumr.shuffle.ram.mb": 0.3,
                                        "tpumr.shuffle.parallel.copies": 3}),
                           src, 12, 0, str(tmp_path), reporter)
    segs = copier.copy_all()
    assert copier.inmem_merges >= 1
    assert reporter.counters.value(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.SHUFFLE_INMEM_MERGES) \
        == copier.inmem_merges
    live_mem = sum(s.raw_length for s in segs if isinstance(s,
                                                           MemorySegment))
    assert copier.ram.used == live_mem
    want = list(ifile.merge_sorted(
        [list(ifile.iter_chunked_segment(
            [d[ix["partitions"][0][0] + 4:]], ix["codec"]))
         for d, ix in spills], None))
    assert list(ifile.merge_sorted(segs, None)) == want
    for s in segs:
        s.close()
    assert copier.ram.used == 0


def test_background_merge_runs_the_combiner(tmp_path, no_leaked_threads):
    """TestBackgroundMerge::test_combiner_runs_at_shuffle_merge_time."""
    from tpumr_torch.io.writable import deserialize
    spills = _int_spills(10, 300)
    conf = conf_with(**{"tpumr.shuffle.ram.mb": 0.05})
    conf.set_combiner_class(SumCombiner)
    reporter = Reporter()
    copier = ShuffleCopier(conf, SpillChunkSource(spills), 10, 0,
                           str(tmp_path), reporter)
    segs = copier.copy_all()
    assert copier.inmem_merges >= 1
    assert reporter.counters.value(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.COMBINE_INPUT_RECORDS) > 0
    totals = {}
    for kb, vb in ifile.merge_sorted(segs, None):
        totals[deserialize(kb)] = totals.get(deserialize(kb), 0) \
            + deserialize(vb)
    assert totals == {f"k{k:05d}": 55 for k in range(300)}
    for s in segs:
        s.close()


def test_disk_segments_fold_into_runs(tmp_path, no_leaked_threads):
    """TestDiskBackgroundMerge::test_manager_folds_spills_into_runs: every
    io.sort.factor disk segments become one run."""
    ram = ShuffleRamManager(1 << 20)
    conf = conf_with(**{"io.sort.factor": 3})
    mgr = ShuffleMergeManager(conf, ram, str(tmp_path), Reporter())
    segs = []
    for m in range(6):
        recs = records_for(50, b"d%d" % m)
        data, index = make_spill(recs)
        path = tmp_path / f"seg{m}"
        path.write_bytes(data)
        off, raw, plen = index["partitions"][0]
        seg = DiskSegment(str(path), "zlib", raw, offset=off + 4,
                          length=plen - 4)
        segs.append(seg)
        assert mgr.offer_disk(m, seg)
    deadline = time.monotonic() + 5
    while mgr.disk_merges < 2:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    runs = mgr.finish()
    assert mgr.disk_merges == 2 and mgr.disk_merge_segments == 6
    assert [r.records for r in runs] == [150, 150]
    assert not any(os.path.exists(s.path) for s in segs)
    got = list(ifile.merge_sorted(runs, None))
    assert got == sorted(r for m in range(6)
                         for r in records_for(50, b"d%d" % m))
    for r in runs:
        r.close()


# ---------------------------------------------- bytes against the JAX's


def _segments(n, rng):
    """n sorted segments with keys repeating inside and across them."""
    out = []
    for s in range(n):
        keys = sorted(int(k) for k in rng.integers(0, 40, size=30 + 7 * s))
        out.append([(b"k%03d" % k, b"s%d-%d" % (s, i))
                    for i, k in enumerate(keys)])
    return out


def _reverse_key(k):
    return bytes(255 - b for b in k)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("order", ["raw", "none", "reversed"])
def test_merges_are_the_jax_packages_bytes(n, order):
    """TestRawFastPath: merge_sorted (the two-way loop, the k-way heap,
    a key function) and merge_sorted_inmem give the JAX package's records
    in the JAX package's order, equal keys in segment order."""
    rng = np.random.default_rng(n)
    segs = _segments(n, rng)
    key = {"raw": lambda k: k, "none": None,
           "reversed": _reverse_key}[order]
    if order == "reversed":
        segs = [sorted(s, key=lambda kv: _reverse_key(kv[0])) for s in segs]
    assert ifile.is_raw_sort_key(key) == jax_ifile.is_raw_sort_key(key)
    want = list(jax_ifile.merge_sorted([list(s) for s in segs], key))
    assert list(ifile.merge_sorted([list(s) for s in segs], key)) == want
    assert ifile.merge_sorted_inmem([list(s) for s in segs], key) == \
        jax_ifile.merge_sorted_inmem([list(s) for s in segs], key) == want


@pytest.mark.parametrize("codec,wire", [("none", "none"), ("none", "zlib"),
                                        ("zlib", "zlib")])
def test_serve_chunk_is_the_jax_packages(tmp_path, codec, wire):
    """tasktracker.serve_chunk of both packages over the same spill file:
    the same chunks, offsets and wire compression, chunk by chunk."""
    recs = [(b"key%05d" % i, b"x" * 40) for i in range(2000)]
    data, index = make_spill(recs, codec=codec, partitions=3)
    path = tmp_path / "file.out"
    path.write_bytes(data)
    port_fds, jax_fds = FdCache(4), JaxFdCache(4)
    total = index["partitions"][0][2] - 4
    off = 0
    while off < total:
        got = serve_chunk(port_fds, str(path), index, 0, off, 5000,
                          4 << 20, wire)
        want = jax_tt.serve_chunk(jax_fds, str(path), index, 0, off, 5000,
                                  4 << 20, wire)
        assert got == want
        off += got["n"]
    assert off == total
    empty = serve_chunk(port_fds, str(path), index, 2, 0, 5000, 4 << 20,
                        wire)
    assert empty == jax_tt.serve_chunk(jax_fds, str(path), index, 2, 0,
                                       5000, 4 << 20, wire)


@pytest.mark.parametrize("ram_mb", [128.0, 0.05])
def test_a_whole_copy_merges_to_the_jax_copiers_records(tmp_path, ram_mb):
    """Both packages' ShuffleCopier over the same spills (within the
    budget, and at a budget where segments merge in the background), each
    merged by its own merge_sorted: the same records in the same order."""
    spills = [make_spill(records_for(400, b"m", dup_every=7))
              for _ in range(5)]
    port = ShuffleCopier(conf_with(**{"tpumr.shuffle.ram.mb": ram_mb}),
                         SpillChunkSource(spills, delay_s=0), 5, 0,
                         str(tmp_path / "port"))
    jconf = jax_jobconf.JobConf()
    jconf.set("mapred.output.key.comparator.class",
              "tpumr.mapred.api.RawComparator")
    jconf.set("tpumr.shuffle.ram.mb", ram_mb)
    jax = jax_copier.ShuffleCopier(jconf, SpillChunkSource(spills, delay_s=0),
                                   5, 0, str(tmp_path / "jax"))
    psegs, jsegs = port.copy_all(), jax.copy_all()
    assert (port.inmem_merges > 0) == (jax.inmem_merges > 0) \
        == (ram_mb < 1)
    assert list(ifile.merge_sorted(psegs, None)) == \
        list(jax_ifile.merge_sorted(jsegs, None))
    for s in psegs + jsegs:
        s.close()


# --------------------------------------------------------- serving side


def test_fd_cache_evicts_and_invalidates_by_prefix(tmp_path):
    """TestSpillFdCache::test_eviction_under_many_jobs and
    ::test_invalidate_prefix."""
    fds = FdCache(capacity=3)
    paths = []
    for j in range(5):
        d = tmp_path / f"job{j}"
        d.mkdir()
        p = d / "file.out"
        p.write_bytes(b"%d" % j * 10)
        paths.append(str(p))
        assert fds.pread(str(p), 4, 2) == (b"%d" % j) * 4
    assert len(fds) == 3 and fds.evictions == 2
    fds.invalidate(str(tmp_path / "job4") + os.sep)
    assert len(fds) == 2
    os.replace(paths[3], paths[3] + ".old")
    with open(paths[3], "wb") as f:
        f.write(b"new bytes")
    assert fds.pread(paths[3], 3, 0) == b"333"   # still the old inode
    fds.invalidate(str(tmp_path / "job3"))
    assert fds.pread(paths[3], 3, 0) == b"new"
    fds.invalidate()
    assert len(fds) == 0


def test_wire_compression_only_where_it_pays():
    """TestSpillFdCache::test_wire_compression_only_when_it_pays."""
    text = {"data": b"abcd" * 1000, "codec": "none"}
    wire_compress(text, "zlib")
    assert text["wire"] == "zlib" and len(text["data"]) < 4000
    noise = {"data": np.random.default_rng(0).bytes(4000), "codec": "none"}
    wire_compress(noise, "zlib")
    assert "wire" not in noise and len(noise["data"]) == 4000
    for out in ({"data": b"abcd" * 1000, "codec": "zlib"},
                {"data": b"a" * (WIRE_MIN_BYTES - 1), "codec": "none"}):
        before = dict(out)
        wire_compress(out, "zlib")
        assert out == before
    tlz = {"data": b"abcd" * 1000, "codec": "none"}
    wire_compress(tlz, "tlz")   # not a codec of the port: sent as it is
    assert "wire" not in tlz


# ------------------------------------------------------ on the cluster


def _tera_conf(conf, gen, out, reduces=4):
    from tpumr_torch.examples.terasort import make_terasort_conf
    job = make_terasort_conf(gen, out, reduces)
    for k, v in conf:
        if job.get(k) is None:
            job.set(k, v)
    return job


def _parts(fs, out):
    from tpumr_torch.io import sequencefile
    parts = sorted(str(st.path) for st in fs.list_files(out)
                   if st.path.name.startswith("part-"))
    got = []
    for p in parts:
        f = fs.open(p)
        try:
            got.append(list(sequencefile.Reader(f)))
        finally:
            f.close()
    return got


def test_host_shuffle_on_the_cluster_equals_the_local_run():
    """chip_smoke.py's cluster_shuffle (b) at 4,000 records: a TeraSort's
    host shuffle on the port's MiniMRCluster, within the default budget
    and then with segments on disk and merged in the background, part for
    part the records of the port's LocalJobRunner."""
    from tpumr_torch.examples import terasort
    from tpumr_torch.fs.filesystem import FileSystem
    from tpumr_torch.mapred.job_client import JobClient
    from tpumr_torch.mapred.local_runner import run_job
    from tpumr_torch.mapred.mini_cluster import MiniMRCluster
    FileSystem.clear_cache()
    base = JobConf()
    base.set(DEVICE_KEY, "cpu")
    gen = "mem:///hs/gen"
    assert terasort.teragen(["4000", gen, "-m", "3", "-D",
                             f"{DEVICE_KEY}=cpu"]) == 0
    fs = FileSystem.get(gen, base)
    local = _tera_conf(base, gen, "mem:///hs/local")
    assert run_job(local).successful
    want = _parts(fs, "mem:///hs/local")
    assert sum(map(len, want)) == 4000
    with MiniMRCluster(num_trackers=1, cpu_slots=4, tpu_slots=0,
                       conf=base) as c:
        runs = {}
        for tag, extra in (("default", {}),
                           ("disk", {"tpumr.shuffle.ram.mb": 0.02,
                                     "io.sort.factor": 2})):
            conf = _tera_conf(c.create_job_conf(), gen, f"mem:///hs/{tag}")
            for k, v in extra.items():
                conf.set(k, v)
            client = JobClient(conf)
            try:
                running = client.submit_job(conf)
                st = running.wait_for_completion(timeout=60)
                runs[tag] = running.counters()
            finally:
                client.close()
            assert st["state"] == "SUCCEEDED", st
            assert _parts(fs, f"mem:///hs/{tag}") == want
    g = TaskCounter.FRAMEWORK_GROUP
    assert runs["default"].value(g, TaskCounter.REDUCE_SHUFFLE_SEGMENTS_MEM) \
        == 12
    assert runs["disk"].value(g, TaskCounter.REDUCE_SHUFFLE_SEGMENTS_DISK) > 0
    assert runs["disk"].value(g, TaskCounter.SHUFFLE_DISK_MERGES) >= 1
    FileSystem.clear_cache()
