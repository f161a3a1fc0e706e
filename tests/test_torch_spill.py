"""The port's spill-and-merge path against the JAX package's: the merge
engine (tpumr_torch.io.merger), the map output buffer's spills and their
merge (tpumr_torch.mapred.map_task.MapOutputBuffer), compressed segments
(tpumr_torch.io.ifile, tpumr_torch.io.compress) and the reduce's merge,
grouping and seams (tpumr_torch.mapred.reduce_task), on the same records
made from numpy seeds. Everything here is host code: files, indexes, part
files and counters must be equal, not close.
"""

import io
import os

import numpy as np
import pytest

from tpumr.io import ifile as jax_ifile
from tpumr.io import merger as jax_merger
from tpumr.io.writable import read_vint as jax_read_vint
from tpumr.mapred.api import Reporter as JaxReporter
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr.mapred.map_task import MapOutputBuffer as JaxMapOutputBuffer
from tpumr.mapred.reduce_task import run_reduce_task as jax_run_reduce_task
from tpumr.mapred.task import Task as JaxTask
from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io import ifile, merger
from tpumr_torch.io.compress import get_codec
from tpumr_torch.io.writable import deserialize, read_vint
from tpumr_torch.mapred.api import Reporter
from tpumr_torch.mapred.ids import JobID, TaskAttemptID, TaskID
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job
from tpumr_torch.mapred.map_task import MapOutputBuffer
from tpumr_torch.mapred.reduce_task import run_reduce_task
from tpumr_torch.mapred.task import Task

CODECS = ["none", "zlib", "gzip", "bzip2", "lzma"]


@pytest.fixture(autouse=True)
def _fresh_mem():
    FileSystem.clear_cache()
    yield
    FileSystem.clear_cache()


def rand_segments(n_segs, n_recs, seed=0):
    """Sorted segments with many equal keys across segments and values
    unique to their segment, so the order of equal keys shows
    (tests/test_merge_engine.py::rand_segments, from numpy seeds)."""
    rng = np.random.default_rng(seed)
    space = max(4, n_recs // 2)
    return [sorted((b"k%06d" % int(rng.integers(space)), b"s%d-%04d" % (s, i))
                   for i in range(n_recs))
            for s in range(n_segs)]


class CloseTracking(list):
    closed = False

    def close(self):
        self.closed = True


def nonzero(counters) -> dict:
    return {g: {n: v for n, v in names.items() if v}
            for g, names in counters.to_dict().items()
            if any(names.values())}


def files_under(path) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


# ------------------------------------------------------------ the merger


@pytest.mark.parametrize("n_segs", [1, 3, 4, 5, 12])
def test_multipass_merge_equals_flat_and_jax(n_segs, tmp_path):
    """Mirrors tests/test_merge_engine.py::TestBoundedMerge::
    test_multipass_byte_identical_to_flat, against the JAX package's
    BoundedMerge on the same runs: the same records, passes and fan-in."""
    segs = rand_segments(n_segs, 200, seed=n_segs)
    flat = list(ifile.merge_sorted([list(s) for s in segs], None))
    bm = merger.BoundedMerge([list(s) for s in segs], lambda k: k, 4,
                             run_dir=str(tmp_path / "port"))
    jbm = jax_merger.BoundedMerge([list(s) for s in segs], lambda k: k, 4,
                                  run_dir=str(tmp_path / "jax"))
    got, want = list(bm), list(jbm)
    assert got == want == flat
    assert (bm.passes, bm.max_fan_in) == (jbm.passes, jbm.max_fan_in)
    assert bm.max_fan_in <= 4 and (bm.passes > 0) == (n_segs > 4)
    bm.close()
    jbm.close()
    assert not os.path.exists(tmp_path / "port") or \
        os.listdir(tmp_path / "port") == []


def test_fan_in_never_exceeds_factor_wide(tmp_path):
    """Mirrors TestBoundedMerge::test_fan_in_never_exceeds_factor_wide,
    with runs of unequal sizes so that the pass windows move."""
    rng = np.random.default_rng(7)
    segs = [rand_segments(1, int(n), seed=i)[0]
            for i, n in enumerate(rng.integers(1, 60, size=33))]
    bm = merger.BoundedMerge(segs, None, 5, run_dir=str(tmp_path / "p"))
    jbm = jax_merger.BoundedMerge(segs, None, 5, run_dir=str(tmp_path / "j"))
    assert list(bm) == list(jbm) == list(ifile.merge_sorted(segs, None))
    assert bm.max_fan_in <= 5 and bm.passes >= 7
    assert (bm.passes, bm.max_fan_in) == (jbm.passes, jbm.max_fan_in)
    bm.close()
    jbm.close()


def test_pass_counters_and_input_close(tmp_path):
    """Mirrors TestBoundedMerge::test_pass_counters_and_input_close: the
    same MERGE_PASSES and MERGE_PASS_SEGMENTS as the JAX package's, and
    every input merged by a pass closed."""
    reporter, jreporter = Reporter(), JaxReporter()
    segs = [CloseTracking(s) for s in rand_segments(9, 50)]
    jsegs = [CloseTracking(s) for s in rand_segments(9, 50)]
    bm = merger.BoundedMerge(segs, None, 3, run_dir=str(tmp_path / "p"),
                             reporter=reporter)
    jbm = jax_merger.BoundedMerge(jsegs, None, 3, run_dir=str(tmp_path / "j"),
                                  reporter=jreporter)
    assert list(bm) == list(jbm)
    assert nonzero(reporter.counters) == nonzero(jreporter.counters)
    assert reporter.counters.value(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.MERGE_PASSES) == bm.passes > 0
    assert reporter.counters.value(
        TaskCounter.FRAMEWORK_GROUP, TaskCounter.MERGE_PASS_SEGMENTS) > 0
    assert [s.closed for s in segs] == [s.closed for s in jsegs]
    assert sum(s.closed for s in segs) >= bm.passes
    bm.close()
    jbm.close()


@pytest.mark.parametrize("n_sizes", [2, 5, 9, 17])
def test_pass_width_and_min_window_equal_jax(n_sizes):
    """io/merger.py::_pass_width and ::_min_window over random run sizes,
    ties included (sizes drawn from a small range)."""
    rng = np.random.default_rng(n_sizes)
    runs = [type("R", (), {"raw_length": int(s)})()
            for s in rng.integers(0, 4, size=n_sizes)]
    for factor in (2, 3, 4, 10):
        for first in (True, False):
            w = merger._pass_width(n_sizes, factor, first)
            assert w == jax_merger._pass_width(n_sizes, factor, first)
            if w <= n_sizes:
                assert merger._min_window(runs, w) == \
                    jax_merger._min_window(runs, w)


def test_streaming_run_decodes_as_ifile_segment(tmp_path):
    """Mirrors TestBoundedMerge::test_streaming_run_decodes_as_ifile_
    segment; the run file is byte-identical to the JAX package's."""
    recs = rand_segments(1, 5000, seed=11)[0]
    run = merger.write_run_streaming(iter(recs), str(tmp_path / "p"))
    jrun = jax_merger.write_run_streaming(iter(recs), str(tmp_path / "j"))
    assert list(run) == recs
    assert run.records == len(recs)
    index = {"codec": "none",
             "partitions": [(4, run.raw_length, run.length + 4)]}
    assert list(ifile.read_partition(run.path, index, 0)) == recs
    with open(run.path, "rb") as f, open(jrun.path, "rb") as g:
        assert f.read() == g.read()
    run.close()
    jrun.close()
    assert not os.path.exists(run.path)


def test_padded_vint_roundtrip():
    """Mirrors TestBoundedMerge::test_padded_vint_roundtrip."""
    for n in (0, 1, 127, 128, 100000, 2**34 - 1):
        padded = merger._padded_vint(n)
        assert padded == jax_merger._padded_vint(n)
        assert read_vint(io.BytesIO(padded)) == n
        assert jax_read_vint(io.BytesIO(padded)) == n
    with pytest.raises(ValueError):
        merger._padded_vint(2**35)


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_write_run_format_matches_writer(codec, tmp_path):
    """Mirrors TestBoundedMerge::test_write_run_format_matches_writer:
    write_run's file equals ifile.Writer's one partition and the JAX
    package's write_run."""
    recs = rand_segments(1, 100, seed=9)[0]
    run = merger.write_run(iter(recs), str(tmp_path / "p"), codec=codec)
    jrun = jax_merger.write_run(iter(recs), str(tmp_path / "j"), codec=codec)
    assert list(run) == recs and run.records == len(recs)
    buf = io.BytesIO()
    w = ifile.Writer(buf, codec=codec)
    w.start_partition()
    for k, v in recs:
        w.append_raw(k, v)
    w.end_partition()
    w.close()
    with open(run.path, "rb") as f, open(jrun.path, "rb") as g:
        data = f.read()
        assert data == buf.getvalue() == g.read()
    run.close()
    jrun.close()
    assert not os.path.exists(run.path)


@pytest.mark.parametrize("codec", CODECS)
def test_chunked_segment_and_writer_equal_jax(codec, tmp_path):
    """tpumr/io/ifile.py::Writer, ::iter_chunked_segment,
    ::file_region_chunks and ::iter_transferred_segment under each stdlib
    codec: the same file and index as the JAX package's writer (but for
    gzip, whose header holds the time), and the records decoded back from
    chunks of 7 bytes."""
    segs = rand_segments(3, 300, seed=3)
    buf, jbuf = io.BytesIO(), io.BytesIO()
    w, jw = ifile.Writer(buf, codec=codec), jax_ifile.Writer(jbuf, codec=codec)
    for seg in segs:
        for wr in (w, jw):
            wr.start_partition()
            for k, v in seg:
                wr.append_raw(k, v)
            wr.end_partition()
    index, jindex = w.close(), jw.close()
    if codec != "gzip":
        assert buf.getvalue() == jbuf.getvalue() and index == jindex
    path = tmp_path / "file.out"
    path.write_bytes(buf.getvalue())
    for p, seg in enumerate(segs):
        off, raw_len, part_len = index["partitions"][p]
        chunks = ifile.file_region_chunks(str(path), off + 4, part_len - 4,
                                          chunk_bytes=7)
        assert list(ifile.iter_chunked_segment(chunks, codec)) == seg
        assert list(ifile.read_partition(str(path), index, p)) == seg
        data = ifile.partition_bytes(io.BytesIO(buf.getvalue()), index, p)
        assert list(ifile.iter_transferred_segment(data, codec)) == seg
        assert list(jax_ifile.iter_transferred_segment(data, codec)) == seg
    comp = get_codec(codec).compress(b"x" * 5000)
    dec = get_codec(codec).decompressor()
    assert b"".join(dec.feed(comp[i:i + 3])
                    for i in range(0, len(comp), 3)) + dec.flush() == \
        b"x" * 5000


def test_chunked_segment_truncated_raises():
    """A payload cut short raises EOFError, as the JAX package's
    iter_chunked_segment does."""
    buf = io.BytesIO()
    w = ifile.Writer(buf)
    w.start_partition()
    w.append_raw(b"key", b"value")
    w.end_partition()
    data = buf.getvalue()[8:-2]      # past the magic and the length
    for decode in (ifile.iter_chunked_segment,
                   jax_ifile.iter_chunked_segment):
        with pytest.raises(EOFError):
            list(decode([data], "none"))


# ----------------------------------------------------- MapOutputBuffer


def _buffer_conf(conf, spills, combiner, factor, codec, pkg):
    conf.set("io.sort.mb", 1)
    # a record here counts about 30 bytes against the threshold
    conf.set("io.sort.spill.percent", {"none": 1.0, "one": 1.0,
                                       "many": 0.0006}[spills])
    conf.set("io.sort.factor", factor)
    if codec != "none":
        conf.set("mapred.compress.map.output", True)
        conf.set("mapred.map.output.compression.codec", codec)
    if combiner:
        conf.set("mapred.combiner.class",
                 f"{pkg}.examples.basic.LongSumReducer")
    return conf


def _records(spills):
    if spills == "none":
        return []
    rng = np.random.default_rng(5)
    n = 300 if spills == "one" else 500
    keys = rng.integers(0, 40, size=n)
    vals = rng.integers(-5, 100, size=n)
    return [(f"k{int(k):03d}", int(v)) for k, v in zip(keys, vals)]


@pytest.mark.parametrize("codec", ["none", "zlib"])
@pytest.mark.parametrize("factor", [2, 10])
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("spills", ["none", "one", "many"])
def test_map_output_buffer_equals_jax(spills, combiner, factor, codec,
                                      tmp_path):
    """tpumr/mapred/map_task.py::MapOutputBuffer (collect, sort_and_spill,
    flush, _merge_spills) on the same records: file.out and its index
    byte-identical, the same counters, and no spill file or merge-tmp
    left behind."""
    recs = _records(spills)
    out = {}
    for pkg, conf, buffer_cls, reporter in (
            ("tpumr_torch", JobConf(), MapOutputBuffer, Reporter()),
            ("tpumr", JaxJobConf(), JaxMapOutputBuffer, JaxReporter())):
        _buffer_conf(conf, spills, combiner, factor, codec, pkg)
        local = tmp_path / pkg
        buf = buffer_cls(conf, 3, str(local), reporter)
        for k, v in recs:
            buf.collect(k, v)
        n_spills = len(buf._spills) + (1 if buf._buf else 0)
        path, index = buf.flush()
        out[pkg] = (open(path, "rb").read(), index, nonzero(reporter.counters),
                    files_under(local), n_spills)
    assert out["tpumr_torch"] == out["tpumr"]
    _data, index, counters, files, n_spills = out["tpumr_torch"]
    assert files == ["file.out"]
    assert index["codec"] == codec
    passes = counters.get(TaskCounter.FRAMEWORK_GROUP, {}).get(
        TaskCounter.MERGE_PASSES, 0)
    if spills == "many":
        assert n_spills >= 10 and (passes > 0) == (factor < n_spills)
    else:
        assert n_spills == {"none": 0, "one": 1}[spills] and passes == 0
    got = [deserialize_pair(kv) for p in range(3)
           for kv in ifile.read_partition(str(tmp_path / "tpumr_torch" /
                                              "file.out"), index, p)]
    sums: dict = {}
    for k, v in recs:
        sums[k] = sums.get(k, 0) + v
    if combiner:
        assert sorted(got) == sorted(sums.items())
    else:
        assert sorted(got) == sorted(recs)


def deserialize_pair(kv):
    return deserialize(kv[0]), deserialize(kv[1])


def test_failed_merge_leaves_no_merge_tmp(tmp_path, monkeypatch):
    """A merge that raises removes merge-tmp (the JAX package's
    _merge_spills leaves it to the attempt's cleanup; the port removes it
    at once)."""
    conf = _buffer_conf(JobConf(), "many", False, 2, "none", "tpumr_torch")
    buf = MapOutputBuffer(conf, 2, str(tmp_path), Reporter())
    for k, v in _records("many"):
        buf.collect(k, v)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(merger, "write_run_streaming", boom)
    with pytest.raises(OSError, match="disk full"):
        buf.flush()
    assert not os.path.exists(tmp_path / "merge-tmp")


# ------------------------------------------------------------- reduce


def _task(partition, num_reduces, num_maps, jax=False):
    if jax:
        from tpumr.mapred.ids import JobID as JJobID
        from tpumr.mapred.ids import TaskAttemptID as JAttempt
        from tpumr.mapred.ids import TaskID as JTaskID
        aid = JAttempt(JTaskID(JJobID("t", 1), False, partition), 0)
        return JaxTask(aid, partition=partition, num_reduces=num_reduces,
                       num_maps=num_maps)
    aid = TaskAttemptID(TaskID(JobID("t", 1), False, partition), 0)
    return Task(aid, partition=partition, num_reduces=num_reduces,
                num_maps=num_maps)


def _write_lines(path, lines):
    path.write_text("".join(line + "\n" for line in lines))


def _secondary_sort_lines():
    """tests/test_examples.py::TestSecondarySort's data, from its seed."""
    rng = np.random.default_rng(5)
    lines = []
    for first in (3, 1, 2):
        for second in rng.permutation(20):
            lines.append(f"{first} {int(second)}")
    rng.shuffle(lines)
    return lines


def _both_jobs(tmp_path, keys, name, reduces=1):
    confs = []
    for pkg, conf in (("tpumr_torch", JobConf()), ("tpumr", JaxJobConf())):
        conf.set_input_paths(f"file://{tmp_path}/in")
        conf.set_output_path(f"file://{tmp_path}/{name}-{pkg}")
        conf.set_num_reduce_tasks(reduces)
        for k, v in keys.items():
            conf.set(k, v.replace("PKG", pkg) if isinstance(v, str) else v)
        confs.append(conf)
    confs[0].set("tpumr_torch.device", "cpu")
    return confs


def _parts(path):
    return {n: (path / n).read_bytes() for n in sorted(os.listdir(path))
            if n.startswith("part-")}


def test_grouping_comparator_groups_as_the_reference(tmp_path):
    """The repaired fault: tpumr/mapred/reduce_task.py groups under
    mapred.output.value.groupfn.class (:47-48, :176) while the merge keeps
    the output-key comparator's order. On the secondarysort data, keys
    (first, second) grouped by their first element: one group per first
    with its seconds ascending, the same part file bytes as the JAX
    package's (the port grouped by whole pairs before)."""
    (tmp_path / "in").mkdir()
    _write_lines(tmp_path / "in" / "data.txt", _secondary_sort_lines())
    keys = {"mapred.mapper.class": "PKG.examples.secondary_sort.PairMapper",
            "mapred.reducer.class":
                "PKG.examples.secondary_sort.SortedValuesReducer",
            "mapred.partitioner.class":
                "PKG.examples.secondary_sort.FirstPartitioner",
            "mapred.output.value.groupfn.class":
                "PKG.examples.secondary_sort.FirstGroupingComparator",
            "io.sort.mb": 1, "io.sort.spill.percent": 0.0002}
    conf, jconf = _both_jobs(tmp_path, keys, "ss", reduces=2)
    res, jres = run_job(conf), jax_run_job(jconf)
    assert res.successful and jres.successful
    got = _parts(tmp_path / "ss-tpumr_torch")
    assert got == _parts(tmp_path / "ss-tpumr")
    lines = b"".join(got.values()).decode().splitlines()
    assert sorted(int(line.split("\t")[0]) for line in lines) == [1, 2, 3]
    for line in lines:
        assert line.split("\t")[1] == str(list(range(20)))
    c = res.counters
    assert c.value(TaskCounter.FRAMEWORK_GROUP,
                   TaskCounter.REDUCE_INPUT_GROUPS) == 3
    assert c.value(TaskCounter.FRAMEWORK_GROUP,
                   TaskCounter.REDUCE_INPUT_RECORDS) == 60


class SeamReducer:
    """A reducer recording its seams, for both packages' reduce tasks."""

    log: list = []

    def configure(self, conf):
        SeamReducer.log.append(("configure", conf.get("tpumr.task.work.dir")))

    def begin_task(self, output, reporter):
        SeamReducer.log.append(("begin_task",))

    def reduce(self, key, values, output, reporter):
        output.collect(key, sum(values))

    def close(self):
        SeamReducer.log.append(("close",))


class FailingSetupReducer(SeamReducer):
    def configure(self, conf):
        raise RuntimeError("setup failed")


class Segments:
    """A ``segments(partition)`` source over in-memory runs."""

    def __init__(self, runs):
        self.runs = runs
        self.given = []

    def segments(self, partition):
        self.given = [CloseTracking(r) for r in self.runs]
        return list(self.given)


def _reduce_conf(conf, out, reducer):
    conf.set_output_path(out)
    conf.set_class("mapred.reducer.class", reducer)
    conf.set("mapred.output.key.comparator.class",
             type(conf).__module__.split(".")[0] + ".mapred.api.RawComparator")
    return conf


def test_begin_task_on_an_empty_partition_and_work_dir_before_configure(
        tmp_path):
    """tpumr/mapred/reduce_task.py::_reduce_merged (:134-138, :173-175):
    tpumr.task.work.dir is set before the reducer's configure, and
    begin_task is called on a partition with no groups, by both
    packages."""
    logs = {}
    for pkg, conf, runner, task in (
            ("tpumr_torch", JobConf(), run_reduce_task, _task(1, 2, 1)),
            ("tpumr", JaxJobConf(), jax_run_reduce_task,
             _task(1, 2, 1, jax=True))):
        SeamReducer.log = []
        _reduce_conf(conf, f"file://{tmp_path}/{pkg}", SeamReducer)
        runner(conf, task, Segments([[]]),
               Reporter() if pkg == "tpumr_torch" else JaxReporter())
        logs[pkg] = SeamReducer.log
    assert [e[0] for e in logs["tpumr_torch"]] == \
        [e[0] for e in logs["tpumr"]] == ["configure", "begin_task", "close"]
    wd = logs["tpumr_torch"][0][1]
    assert wd and wd.endswith("_temporary/" + str(_task(1, 2, 1).attempt_id))


def test_segments_closed_when_reducer_setup_raises(tmp_path):
    """tpumr/mapred/reduce_task.py::run_reduce_task (:54-104): every
    segment is closed even where the reducer's setup raises."""
    for pkg, conf, runner, task in (
            ("tpumr_torch", JobConf(), run_reduce_task, _task(0, 1, 3)),
            ("tpumr", JaxJobConf(), jax_run_reduce_task,
             _task(0, 1, 3, jax=True))):
        _reduce_conf(conf, f"file://{tmp_path}/{pkg}", FailingSetupReducer)
        src = Segments(rand_segments(3, 20))
        with pytest.raises(RuntimeError, match="setup failed"):
            runner(conf, task, src,
                   Reporter() if pkg == "tpumr_torch" else JaxReporter())
        assert len(src.given) == 3 and all(s.closed for s in src.given)


def test_wide_reduce_equals_jax(tmp_path):
    """A reduce over 12 map outputs at io.sort.factor 3 (intermediate
    passes on both sides, tpumr/mapred/reduce_task.py:108-126): part files
    byte-identical to the JAX package's, and the same merge counters."""
    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(12)
    for m in range(12):
        words = rng.integers(0, 50, size=(40, 6))
        _write_lines(tmp_path / "in" / f"f{m:02d}.txt",
                     [" ".join(f"w{int(x):02d}" for x in row)
                      for row in words])
    keys = {"mapred.mapper.class": "PKG.ops.wordcount.WordCountCpuMapper",
            "mapred.reducer.class": "PKG.examples.basic.LongSumReducer",
            "io.sort.factor": 3}
    conf, jconf = _both_jobs(tmp_path, keys, "wide", reduces=2)
    res, jres = run_job(conf), jax_run_job(jconf)
    assert res.successful and jres.successful and res.num_maps == 12
    assert _parts(tmp_path / "wide-tpumr_torch") == \
        _parts(tmp_path / "wide-tpumr")
    for name in (TaskCounter.MERGE_PASSES, TaskCounter.MERGE_PASS_SEGMENTS,
                 TaskCounter.REDUCE_INPUT_RECORDS):
        assert res.counters.value(TaskCounter.FRAMEWORK_GROUP, name) == \
            jres.counters.value(TaskCounter.FRAMEWORK_GROUP, name)
    assert res.counters.value(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.MERGE_PASSES) == 2 * 5
