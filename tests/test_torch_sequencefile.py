"""The port's SequenceFile (tpumr_torch.io.sequencefile, its codecs in
tpumr_torch.io.compress and the vint stream helpers in
tpumr_torch.io.writable), RecordBatch's keyed methods,
SequenceFileInputFormat and SequenceFileOutputFormat against the JAX
package's, on the same bytes made from numpy seeds. The format is shared:
each package reads what the other wrote, and with the sync marker pinned
the two writers give the same bytes. Everything here is host code: records,
offsets and splits must be equal, not close.
"""

import io
import os

import numpy as np
import pytest

from tpumr.io import recordbatch as jax_recordbatch
from tpumr.io import sequencefile as jax_seq
from tpumr.io.writable import read_vint as jax_read_vint
from tpumr.io.writable import write_vint as jax_write_vint
from tpumr.mapred.input_formats import \
    SequenceFileInputFormat as JaxSeqInputFormat
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io import compress, sequencefile
from tpumr_torch.io.recordbatch import (RecordBatch, fixed_offsets,
                                        offsets_dtype)
from tpumr_torch.io.writable import read_vint, write_vint
from tpumr_torch.mapred.input_formats import SequenceFileInputFormat
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.output_formats import SequenceFileOutputFormat

CODECS = ["none", "zlib", "default", "gzip", "bzip2", "lzma"]


@pytest.fixture(autouse=True)
def _fresh_mem():
    FileSystem.clear_cache()
    yield
    FileSystem.clear_cache()


def _write(mod, records, codec="none", block_records=3, sync_every=0,
           fixed=None):
    buf = io.BytesIO()
    w = mod.Writer(buf, codec=codec, block_records=block_records)
    for i, (k, v) in enumerate(records):
        w.append(k, v)
        if sync_every and i % sync_every == sync_every - 1:
            w.sync_now()
    if fixed is not None:
        w.append_fixed_rows(*fixed)
    w.close()
    return buf.getvalue()


def _records(n=10):
    return [(f"key{i}", {"n": i, "payload": b"x" * i}) for i in range(n)]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_roundtrip_every_stdlib_codec_across_packages(codec, writer, reader):
    """Mirrors tests/test_io.py::test_sequencefile_roundtrip, for every
    codec both packages have, each package reading the other's file."""
    mods = {"port": sequencefile, "jax": jax_seq}
    rows = np.random.default_rng(2).integers(0, 256, (40, 14), np.uint8)
    data = _write(mods[writer], _records(), codec=codec, fixed=(rows, 10))
    got = list(mods[reader].Reader(io.BytesIO(data)))
    assert got == list(jax_seq.Reader(io.BytesIO(data)))
    assert got[:10] == _records()
    assert got[10:] == [(bytes(r[:10]), bytes(r[10:])) for r in rows]
    assert mods[reader].Reader(io.BytesIO(data)).metadata["codec"] == \
        compress.get_codec(codec).name


def test_tlz_is_left_out_with_a_clear_error():
    """The native codec is not ported: asking for it, or reading a file
    the JAX package wrote with it, raises and says so."""
    with pytest.raises(ValueError, match="not ported"):
        compress.get_codec("tlz")
    data = _write(jax_seq, _records(), codec="tlz")
    with pytest.raises(ValueError, match="not ported"):
        sequencefile.Reader(io.BytesIO(data))
    with pytest.raises(ValueError, match="unknown codec"):
        compress.get_codec("nope")


def test_vint_stream_helpers_match_jax():
    """Mirrors tests/test_io.py::test_vint_roundtrip."""
    values = [0, 1, 127, 128, 300, 2 ** 21, 2 ** 35 + 7, 2 ** 63]
    port, jax = io.BytesIO(), io.BytesIO()
    for v in values:
        write_vint(port, v)
        jax_write_vint(jax, v)
    assert port.getvalue() == jax.getvalue()
    port.seek(0)
    assert [read_vint(port) for _ in values] == values
    port.seek(0)
    assert [jax_read_vint(port) for _ in values] == values
    with pytest.raises(EOFError):
        read_vint(io.BytesIO(b"\x80"))


@pytest.mark.parametrize("width,klen", [(14, 10), (100, 10), (10, 10)])
def test_append_fixed_rows_bytes_equal_append_raw(monkeypatch, width, klen):
    """Mirrors tests/test_io.py::TestAppendFixedRows (byte identity, mixed
    appends, zero-width values): with the sync marker pinned, the port's
    append_fixed_rows writes the bytes of per-record appends, the port's
    and the JAX package's alike."""
    rows = np.random.default_rng(0).integers(0, 256, (2500, width),
                                             np.uint8)
    monkeypatch.setattr(os, "urandom", lambda n: b"S" * n)
    per = [(bytes(r[:klen]), bytes(r[klen:])) for r in rows]
    bulk = _write(sequencefile, [], fixed=(rows, klen), block_records=1000)
    assert bulk == _write(sequencefile, per, block_records=1000)
    assert bulk == _write(jax_seq, per, block_records=1000)
    # a record appended one by one before the rows keeps its own block
    mixed = _write(sequencefile, [(b"first", b"xx")], fixed=(rows, klen),
                   block_records=1000)
    assert mixed == _write(jax_seq, [(b"first", b"xx")], fixed=(rows, klen),
                           block_records=1000)
    assert list(sequencefile.Reader(io.BytesIO(mixed))) == \
        [(b"first", b"xx")] + per


def _every_split(data, step=1):
    for cut in range(0, len(data) + 1, step):
        yield [(0, cut), (cut, len(data))]


@pytest.mark.parametrize("kind", ["typed", "fixed"])
def test_ranges_at_every_split_boundary_match_jax(kind):
    """Mirrors tests/test_formats.py:104
    (test_sequencefile_read_batch_mixed_block_widths) and
    tests/test_io.py::test_sequencefile_sync_split: a multi-block file with
    sync markers cut in two at every byte (every 7th for the fixed-width
    file); both halves' iter_range and read_batch_range records equal the
    JAX reader's, and together they hold every record once."""
    if kind == "typed":
        recs = [(i, b"v" * (i % 23)) for i in range(60)]
        data = _write(jax_seq, recs, block_records=3, sync_every=6)
        step = 1
        want = [(i, b"v" * (i % 23)) for i in range(60)]
    else:
        rows = np.random.default_rng(5).integers(32, 127, (40, 100),
                                                 np.uint8)
        data = _write(jax_seq, [], block_records=4, fixed=(rows, 10))
        data = _write(jax_seq, [(bytes(r[:10]), bytes(r[10:]))
                                for r in rows], block_records=4,
                      sync_every=8)
        step = 7
        want = [(bytes(r[:10]), bytes(r[10:])) for r in rows]
    for halves in _every_split(data, step):
        seen, batched = [], []
        for start, end in halves:
            port = list(sequencefile.Reader(io.BytesIO(data))
                        .iter_range(start, end))
            assert port == list(jax_seq.Reader(io.BytesIO(data))
                                .iter_range(start, end)), (start, end)
            seen += port
            pb = sequencefile.Reader(io.BytesIO(data)).read_batch_range(
                start, end)
            jb = jax_seq.Reader(io.BytesIO(data)).read_batch_range(
                start, end)
            assert list(pb) == list(jb), (start, end)
            batched += list(pb)
        assert seen == want
        if kind == "fixed":
            assert batched == want


def test_sync_lands_where_jax_sync_lands():
    """Reader.sync scans in chunks; it must stop where the JAX package's
    byte-by-byte scan stops, from every position (the sync-split
    contract of tests/test_io.py::test_sequencefile_sync_split)."""
    recs = [(i, b"v" * 50) for i in range(100)]
    data = _write(jax_seq, recs, block_records=5, sync_every=20)
    for pos in range(0, len(data) + 2):
        p = sequencefile.Reader(io.BytesIO(data))
        j = jax_seq.Reader(io.BytesIO(data))
        assert (p.sync(pos), p.tell()) == (j.sync(pos), j.tell()), pos


def test_input_format_splits_and_records_match_jax():
    """Mirrors tests/test_formats.py::test_sequencefile_input_format: the
    port's SequenceFileInputFormat plans the JAX package's splits and
    reads the same records from each, record by record and as a batch."""
    data = _write(jax_seq, [(i, f"value-{i}") for i in range(500)],
                  block_records=10)
    FileSystem.get("mem:///").write_bytes("/in/data.seq", data)
    from tpumr.fs.filesystem import FileSystem as JaxFileSystem
    JaxFileSystem.get("mem:///").write_bytes("/in/data.seq", data)
    conf, jconf = JobConf(), JaxJobConf()
    for c in (conf, jconf):
        c.set_input_paths("mem:///in/data.seq")
        c.set("mapred.min.split.size", 1)
        c.set("mapred.max.split.size", 1000)
    fmt, jfmt = SequenceFileInputFormat(), JaxSeqInputFormat()
    splits, jsplits = fmt.get_splits(conf, 5), jfmt.get_splits(jconf, 5)
    assert [(s.start, s.length) for s in splits] == \
        [(s.start, s.length) for s in jsplits]
    assert len(splits) > 5
    got = []
    for s, js in zip(splits, jsplits):
        recs = list(fmt.get_record_reader(s, conf))
        assert recs == list(jfmt.get_record_reader(js, jconf))
        assert list(fmt.read_batch(s, conf)) == \
            list(jfmt.read_batch(js, jconf))
        got += recs
    assert sorted(k for k, _ in got) == list(range(500))


@pytest.mark.parametrize("compressed", [False, True])
def test_output_format_writes_what_jax_reads(compressed):
    """SequenceFileOutputFormat (tpumr/mapred/output_formats.py:88-120):
    mapred.output.compress and its codec key, the per-record and the
    fixed-row writes, read back by the JAX reader."""
    conf = JobConf()
    if compressed:
        conf.set("mapred.output.compress", True)
        conf.set("mapred.output.compression.codec", "bzip2")
    rows = np.arange(300, dtype=np.uint8).reshape(3, 100)
    w = SequenceFileOutputFormat().get_record_writer(conf, "mem:///o", 3)
    w.write(b"k", 7)
    w.write_fixed_rows(rows, 10)
    w.close()
    data = FileSystem.get("mem:///").read_bytes("/o/part-00003")
    r = jax_seq.Reader(io.BytesIO(data))
    assert r.metadata["codec"] == ("bzip2" if compressed else "none")
    assert list(r) == [(b"k", 7)] + [(bytes(x[:10]), bytes(x[10:]))
                                     for x in rows]


def test_recordbatch_keyed_methods_match_jax():
    """Mirrors tests/test_io.py::test_recordbatch_roundtrip, ::_padded and
    ::_concat_slice: from_pairs, key, padded_keys/padded_values (cut,
    padded and fixed-width), concat and slice give the JAX package's
    arrays; offsets past int32 become int64 instead of wrapping."""
    pairs = [(b"ab", b"x" * 5), (b"", b"y"), (b"abcdef", b""), (b"q", b"zz")]
    p = RecordBatch.from_pairs(pairs)
    j = jax_recordbatch.RecordBatch.from_pairs(pairs)
    assert list(p) == list(j) == pairs
    assert [p.key(i) for i in range(4)] == [k for k, _ in pairs]
    for width in (0, 1, 3, 8):
        for name in ("padded_keys", "padded_values"):
            got, want = getattr(p, name)(width, 7), getattr(j, name)(width, 7)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    fixed = RecordBatch.from_pairs([(b"k" * 10, b"v" * 90)] * 3)
    assert fixed.padded_keys(10)[0].base is not None   # a view, no copy
    cat = RecordBatch.concat([p, p.slice(1, 3), RecordBatch.empty()])
    jcat = jax_recordbatch.RecordBatch.concat(
        [j, j.slice(1, 3), jax_recordbatch.RecordBatch.empty()])
    assert list(cat) == list(jcat)
    for a, b in ((cat.key_offsets, jcat.key_offsets),
                 (cat.value_offsets, jcat.value_offsets)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
    assert offsets_dtype(2 ** 31 - 1) == np.int32
    assert offsets_dtype(2 ** 31) == np.int64
    big = fixed_offsets(3, 2 ** 30)
    assert big.dtype == np.int64 and int(big[-1]) == 3 * 2 ** 30
