"""The port's text record path (tpumr_torch.fs.inmem, FileSplit, the line
readers and text input formats, RecordBatch, the record branch of
gpu_runner.stage_batch, combine.combined_stream, the map task's spills
at the threshold) against the JAX package's, on the same bytes made from numpy
seeds. Everything here is host code: records, splits, offsets and counters
must be equal, not close.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

from tpumr.examples.basic import LongSumReducer as JaxLongSumReducer
from tpumr.fs.filesystem import FileSystem as JaxFileSystem
from tpumr.io import recordbatch as jax_recordbatch
from tpumr.io.writable import deserialize as jax_deserialize
from tpumr.io.writable import serialize as jax_serialize
from tpumr.mapred import input_formats as jax_formats
from tpumr.mapred.api import Reporter as JaxReporter
from tpumr.mapred.combine import combined_stream as jax_combined_stream
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr.mapred.split import FileSplit as JaxFileSplit
from tpumr.mapred.tpu_runner import stage_batch as jax_stage_batch
from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.examples.basic import LongSumReducer
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io.recordbatch import RecordBatch
from tpumr_torch.io.writable import deserialize, serialize
from tpumr_torch.mapred import input_formats
from tpumr_torch.mapred.api import Reporter
from tpumr_torch.mapred.combine import combined_stream
from tpumr_torch.mapred.gpu_runner import stage_batch
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job
from tpumr_torch.mapred.split import FileSplit, InputSplit
from tpumr_torch.ops.wordcount import tokenize_count

#: a small file with every boundary case of a line: CRLF, a lone and a
#: doubled CR before LF, an empty line, invalid UTF-8, a valid multi-byte
#: character, and no final newline
TRICKY = (b"alpha beta\r\n\xff\xfe bad\ncaf\xc3\xa9\r\r\n\n"
          b"x\ry z\n\xe2\x82 cut\nlast line no newline")


@pytest.fixture(autouse=True)
def _fresh_mem():
    """Fresh port filesystems per test (tests/conftest.py does the same for
    the JAX package's), so mem:// files never outlive their test."""
    FileSystem.clear_cache()
    yield
    FileSystem.clear_cache()


def _both_confs(**keys):
    conf, jconf = JobConf(), JaxJobConf()
    for k, v in keys.items():
        conf.set(k, v)
        jconf.set(k, v)
    return conf, jconf


def _write_both(uri, data):
    """The same bytes through both packages' filesystems (mem:// holds one
    store per package)."""
    for fs_cls in (FileSystem, JaxFileSystem):
        fs = fs_cls.get(uri)
        with fs.create(uri) as f:
            f.write(data)


def _plan(splits):
    return [(type(s).__name__, s.path, s.start, s.split_length,
             list(s.locations)) for s in splits]


# ----------------------------------------------------------- split plans


@pytest.mark.parametrize("scheme", ["file", "mem"])
@pytest.mark.parametrize("keys,hint", [
    ({}, 1),
    ({}, 7),
    ({"mapred.max.split.size": 300_000}, 1),
    ({"mapred.min.split.size": 5_000_000}, 9),
    ({"mapred.max.split.size": 1_000_003}, 3),
])
def test_split_plans_match_jax(tmp_path, scheme, keys, hint):
    """Mirrors tpumr/mapred/input_formats.py::FileInputFormat.get_splits:
    the same (path, start, length, hosts) on file:// (64 MB blocks, one
    host) and mem:// (4 MB blocks on three fake hosts), with the 1.1 slop,
    hidden files skipped and a directory listed."""
    rng = np.random.default_rng(7)
    base = (f"file://{tmp_path}/in" if scheme == "file"
            else f"mem://{tmp_path}/in")
    for name, size in [("a.txt", 9_500_000), ("b.txt", 4_194_304 + 17),
                       ("c.txt", 0), ("_hidden", 100), (".dot", 100)]:
        _write_both(f"{base}/{name}", rng.integers(
            0, 256, size, dtype=np.uint8).tobytes())
    conf, jconf = _both_confs(**{"mapred.input.dir": base}, **keys)
    got = input_formats.TextInputFormat().get_splits(conf, hint)
    want = jax_formats.TextInputFormat().get_splits(jconf, hint)
    assert _plan(got) == _plan(want)
    assert len(got) > 1
    # a glob names the same files
    conf.set("mapred.input.dir", f"{base}/[ab].txt")
    jconf.set("mapred.input.dir", f"{base}/[ab].txt")
    assert _plan(input_formats.TextInputFormat().get_splits(conf, hint)) == \
        _plan(jax_formats.TextInputFormat().get_splits(jconf, hint))


@pytest.mark.parametrize("scheme", ["file", "mem"])
@pytest.mark.parametrize("per_map", [1, 3])
def test_nline_splits_and_records_match_jax(tmp_path, scheme, per_map):
    """Mirrors NLineInputFormat.get_splits and get_record_reader: exact
    line ranges of linespermap lines, the last one short."""
    uri = (f"file://{tmp_path}/seeds.txt" if scheme == "file"
           else f"mem://{tmp_path}/seeds.txt")
    _write_both(uri, b"".join(f"{s} {1000 + s}\n".encode()
                              for s in range(8)) + b"\xff 5\r\n9 9")
    conf, jconf = _both_confs(**{"mapred.input.dir": uri,
                                 "mapred.line.input.format.linespermap":
                                     per_map})
    fmt, jfmt = input_formats.NLineInputFormat(), jax_formats.NLineInputFormat()
    got, want = fmt.get_splits(conf, 1), jfmt.get_splits(jconf, 1)
    assert _plan(got) == _plan(want)
    assert len(got) == -(-10 // per_map)
    for s, js in zip(got, want):
        assert list(fmt.get_record_reader(s, conf)) == \
            list(jfmt.get_record_reader(js, jconf))
    assert getattr(fmt, "read_batch", None) is None


# ---------------------------------------------------- records of a split


def _batch_tuple(b):
    return (b.key_data.tobytes(), b.key_offsets.tolist(),
            b.value_data.tobytes(), b.value_offsets.tolist())


@pytest.mark.parametrize("scheme", ["file", "mem"])
def test_records_of_every_split_match_jax(tmp_path, scheme):
    """Mirrors LineRecordReader, TextInputFormat.read_batch,
    RawTextInputFormat.read_batch and NLineInputFormat.get_record_reader
    over a split [start, end) for every pair of byte offsets of TRICKY
    (CRLF, lone CR, invalid UTF-8, no final newline): the port's records
    and batches equal the JAX package's, a split's batch holds its reader's
    records, and the splits [0, c) and [c, len) (0 < c) together hold
    every line once."""
    uri = (f"file://{tmp_path}/t.txt" if scheme == "file"
           else f"mem://{tmp_path}/t.txt")
    _write_both(uri, TRICKY)
    conf, jconf = _both_confs()
    fs, jfs = FileSystem.get(uri), JaxFileSystem.get(uri)
    n = len(TRICKY)
    text, jtext = input_formats.TextInputFormat(), jax_formats.TextInputFormat()
    raw, jraw = (input_formats.RawTextInputFormat(),
                 jax_formats.RawTextInputFormat())
    nline = input_formats.NLineInputFormat()
    jnline = jax_formats.NLineInputFormat()
    whole = list(input_formats.LineRecordReader(fs, uri, 0, n))
    assert [v for _, v in whole][-1] == "last line no newline"
    for start in range(n + 1):
        for end in range(start, n + 1):
            s = FileSplit([], uri, start, end - start)
            js = JaxFileSplit([], uri, start, end - start)
            for keep in (False, True):
                got = list(input_formats.LineRecordReader(
                    fs, uri, start, end - start, keep))
                assert got == list(jax_formats.LineRecordReader(
                    jfs, uri, start, end - start, keep)), (start, end, keep)
            batch = text.read_batch(s, conf)
            assert _batch_tuple(batch) == \
                _batch_tuple(jtext.read_batch(js, jconf)), (start, end)
            assert [batch.value(i) for i in range(batch.num_records)] == \
                [v.encode() for _, v in text.get_record_reader(s, conf)]
            assert _batch_tuple(raw.read_batch(s, conf)) == \
                _batch_tuple(jraw.read_batch(js, jconf)), (start, end)
            assert list(nline.get_record_reader(s, conf)) == \
                list(jnline.get_record_reader(js, jconf)), (start, end)
        if start > 0:   # a planned split is never empty
            left = list(input_formats.LineRecordReader(fs, uri, 0, start))
            right = list(input_formats.LineRecordReader(fs, uri, start,
                                                        n - start))
            assert left + right == whole, start


def test_record_batch_matches_jax():
    """Mirrors tpumr/io/recordbatch.py::RecordBatch: from_values, empty,
    value, joined_values, num_records and nbytes."""
    vals = [b"", b"abc", "héllo".encode(), b"\x00\xff", b"z" * 70]
    got = RecordBatch.from_values(iter(vals))
    want = jax_recordbatch.RecordBatch.from_values(iter(vals))
    assert _batch_tuple(got) == _batch_tuple(want)
    assert got.num_records == want.num_records == 5
    assert got.nbytes == want.nbytes
    assert [got.value(i) for i in range(5)] == vals
    for sep in (0x20, 0x0A):
        assert got.joined_values(sep) == want.joined_values(sep)
    empty, jempty = RecordBatch.empty(), jax_recordbatch.RecordBatch.empty()
    assert _batch_tuple(empty) == _batch_tuple(jempty)
    assert (empty.num_records, empty.nbytes, empty.joined_values()) == \
        (jempty.num_records, jempty.nbytes, jempty.joined_values())


def test_stage_batch_drains_a_reader_as_jax(tmp_path):
    """Mirrors the record branch of tpumr/mapred/tpu_runner.py::stage_batch:
    a format without read_batch (NLineInputFormat) or a task without a
    split drains the reader into RecordBatch.from_values (strings as
    UTF-8, bytes as they are, other values serialized), counted by the
    reader, staging its nbytes; a format with read_batch hands the split
    over whole, not counted by the reader."""
    records = [(0, "héllo"), (1, b"raw\xff"), (2, 42), (3, np.arange(3)),
               (4, [1.5, "x"])]
    conf, jconf = _both_confs()
    task = SimpleNamespace(split=None, tpu_device_id=-1)
    got = stage_batch(conf, iter(records), task, None)
    want = jax_stage_batch(jconf, iter(records), task, None)
    assert _batch_tuple(got[0]) == _batch_tuple(want[0])
    assert got[1:] == want[1:] == (True, want[0].nbytes)
    assert serialize(np.arange(3)) == jax_serialize(np.arange(3))

    path = tmp_path / "lines.txt"
    path.write_bytes(TRICKY)
    for fmt in ("TextInputFormat", "RawTextInputFormat", "NLineInputFormat"):
        conf, jconf = _both_confs(**{
            "mapred.input.dir": f"file://{path}",
            "mapred.input.format.class": f"tpumr_torch.mapred.input_formats."
                                         f"{fmt}"})
        jconf.set("mapred.input.format.class",
                  f"tpumr.mapred.input_formats.{fmt}")
        fmt_obj = getattr(input_formats, fmt)()
        split = fmt_obj.get_splits(conf, 2)[0]
        jsplit = getattr(jax_formats, fmt)().get_splits(jconf, 2)[0]
        task = SimpleNamespace(split=split.to_dict(), tpu_device_id=-1)
        jtask = SimpleNamespace(split=jsplit.to_dict(), tpu_device_id=-1)
        reader = fmt_obj.get_record_reader(split, conf)
        jreader = getattr(jax_formats, fmt)().get_record_reader(jsplit, jconf)
        got = stage_batch(conf, reader, task, None)
        want = jax_stage_batch(jconf, jreader, jtask, None)
        assert _batch_tuple(got[0]) == _batch_tuple(want[0]), fmt
        assert got[1:] == want[1:], fmt
        assert got[1] is (fmt == "NLineInputFormat")
    assert InputSplit.from_dict(split.to_dict()) == split


# ---------------------------------------------------------- the combiner


class _EmitOnClose(LongSumReducer):
    """Sums per key, and emits one more record when closed (a combiner
    that flushes at its end)."""

    def close(self):
        self._out.collect("zz-closed", 1)

    def reduce(self, key, values, output, reporter):
        self._out = output
        super().reduce(key, values, output, reporter)


class _JaxEmitOnClose(JaxLongSumReducer):
    def close(self):
        self._out.collect("zz-closed", 1)

    def reduce(self, key, values, output, reporter):
        self._out = output
        super().reduce(key, values, output, reporter)


@pytest.mark.parametrize("by_bytes", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "emit_on_close"])
def test_combined_stream_and_its_counters_match_jax(by_bytes, combiner):
    """Mirrors tpumr/mapred/combine.py::combined_stream: the combined
    records, group by group, and COMBINE_INPUT_RECORDS /
    COMBINE_OUTPUT_RECORDS, over a sorted stream of serialized pairs,
    grouped by the deserialized key or by its bytes."""
    rng = np.random.default_rng(11)
    keys = [f"k{i:02d}" for i in rng.integers(0, 12, 200)]
    stream = sorted((serialize(k), serialize(int(v)))
                    for k, v in zip(keys, rng.integers(1, 9, 200)))
    cls, jcls = {"sum": (LongSumReducer, JaxLongSumReducer),
                 "emit_on_close": (_EmitOnClose, _JaxEmitOnClose)}[combiner]
    rep, jrep = Reporter(), JaxReporter()
    got = list(combined_stream(JobConf(), cls,
                               None if by_bytes else deserialize,
                               iter(stream), rep))
    want = list(jax_combined_stream(JaxJobConf(), jcls,
                                    None if by_bytes else jax_deserialize,
                                    iter(stream), jrep))
    assert got == want
    assert len(got) == len(set(keys)) + (combiner == "emit_on_close")
    for name in (TaskCounter.COMBINE_INPUT_RECORDS,
                 TaskCounter.COMBINE_OUTPUT_RECORDS):
        assert rep.counters.value(TaskCounter.FRAMEWORK_GROUP, name) == \
            jrep.counters.value(TaskCounter.FRAMEWORK_GROUP, name), name
    assert rep.counters.value(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.COMBINE_INPUT_RECORDS) == 200


def test_tokenize_count_is_bytes_split():
    """Mirrors tests/test_ops.py's wordcount checks: the numpy tokenizer
    gives collections.Counter(data.split()) for tokens of every length,
    the six whitespace bytes and a buffer that starts and ends inside a
    token."""
    from collections import Counter
    rng = np.random.default_rng(3)
    alphabet = np.frombuffer(b"ab\t\n\x0b\x0c\r xy\x00\xff", np.uint8)
    data = alphabet[rng.integers(0, len(alphabet), 200_000)].tobytes()
    data = b"tok" + data + b"long-token-of-many-bytes-" * 3
    assert dict(tokenize_count(data)) == dict(Counter(data.split()))
    assert dict(tokenize_count(np.frombuffer(data, np.uint8))) == \
        dict(Counter(data.split()))
    assert list(tokenize_count(b"")) == [] == \
        list(tokenize_count(b" \n\t"))


# ------------------------------------------------- the spill threshold


@pytest.mark.parametrize("opt_out", ["cpu_batch_off", "cpu_only"])
def test_per_record_wordcount_raises_past_the_spill_threshold(tmp_path,
                                                              opt_out):
    """Mirrors tpumr/mapred/map_task.py::MapOutputBuffer.collect at the
    spill threshold (io.sort.mb x io.sort.spill.percent): the per-record
    wordcount mapper emits one record per word, so at io.sort.mb=1 each map
    spills several times and merges its spills, with the combiner over each
    spill and over the merge. The name is the one the test had while the
    port raised there; both packages' jobs now succeed with the same part
    file and the same spill and combine counters."""
    rng = np.random.default_rng(1)
    words = [f"word{i:04d}".encode() for i in range(512)]
    idx = rng.integers(0, 512, size=(4000, 12))
    (tmp_path / "text.txt").write_bytes(
        b"\n".join(b" ".join(words[j] for j in r) for r in idx))
    confs = []
    for conf, pkg in ((JobConf(), "tpumr_torch"), (JaxJobConf(), "tpumr")):
        conf.set_input_paths(f"file://{tmp_path}/text.txt")
        conf.set_output_path(f"file://{tmp_path}/out-{pkg}")
        conf.set("io.sort.mb", 1)
        conf.set("mapred.mapper.class",
                 f"{pkg}.ops.wordcount.WordCountCpuMapper")
        conf.set("mapred.reducer.class",
                 f"{pkg}.examples.basic.LongSumReducer")
        conf.set("mapred.combiner.class",
                 f"{pkg}.examples.basic.LongSumReducer")
        if opt_out == "cpu_batch_off":
            conf.set("mapred.input.format.class",
                     f"{pkg}.mapred.input_formats.RawTextInputFormat")
            conf.set("tpumr.map.kernel", "wordcount")
            conf.set("tpumr.cpu.batch.map", False)
        confs.append(conf)
    conf, jconf = confs
    conf.set("tpumr_torch.device", "cpu")
    res, jres = run_job(conf), jax_run_job(jconf)
    assert res.successful and jres.successful
    for name in (TaskCounter.MAP_OUTPUT_RECORDS, TaskCounter.SPILLED_RECORDS,
                 TaskCounter.COMBINE_INPUT_RECORDS,
                 TaskCounter.COMBINE_OUTPUT_RECORDS):
        assert res.counters.value(TaskCounter.FRAMEWORK_GROUP, name) == \
            jres.counters.value(TaskCounter.FRAMEWORK_GROUP, name), name
    assert res.counters.value(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.MAP_OUTPUT_RECORDS) == 4000 * 12
    # spilled twice at least: the combiner ran over more than the map output
    assert res.counters.value(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.COMBINE_INPUT_RECORDS) > 4000 * 12
    text = (tmp_path / "out-tpumr_torch" / "part-00000").read_text()
    assert text == (tmp_path / "out-tpumr" / "part-00000").read_text()
    lines = text.splitlines()
    assert sum(int(line.split("\t")[1]) for line in lines) == 4000 * 12
    assert re.fullmatch(r"word\d{4}\t\d+", lines[0])
