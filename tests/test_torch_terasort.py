"""The port's TeraSort path against the JAX package's, on the CPU: the
device sort's primitives (tpumr_torch.parallel.device_sort), the
device-shuffled reduce (tpumr_torch.mapred.device_shuffle), total order
(tpumr_torch.mapred.total_order), the map task's batch seams, and
teragen, terasort and teravalidate (tpumr_torch.examples.terasort).

The port runs with tpumr_torch.device=cpu; the JAX side runs as its own
tests run it (tests/test_device_shuffle.py on the conftest's eight virtual
CPU devices). Part files are compared as decoded record sequences, part
for part: each writer draws its own sync marker, so their bytes differ by
design. The partition file has no marker and is byte-identical. Equal
keys must come out in the same order too (the maps in order, then the
records of each map), so inputs with many equal keys are among them.
"""

import bisect
import io
import os

import numpy as np
import pytest
import torch

from tpumr.cli import main as jax_cli
from tpumr.examples import terasort as jax_terasort
from tpumr.io import sequencefile as jax_seq
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr.parallel import device_sort as jax_device_sort
from tpumr_torch.cli import main as cli
from tpumr_torch.core.counters import BackendCounter, TaskCounter
from tpumr_torch.examples import terasort
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io import sequencefile
from tpumr_torch.io.recordbatch import RecordBatch
from tpumr_torch.mapred.api import (DeserializingComparator, IdentityMapper,
                                    OutputCollector)
from tpumr_torch.mapred.device_shuffle import prepare_device_shuffle_job
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job
from tpumr_torch.mapred.output_formats import SequenceFileOutputFormat
from tpumr_torch.parallel import device_sort

CPU = ["-D", "tpumr_torch.device=cpu"]


@pytest.fixture(autouse=True)
def _fresh_mem():
    FileSystem.clear_cache()
    yield
    FileSystem.clear_cache()


def _keys(seed, n, lo=0, hi=256, klen=10):
    return np.random.default_rng(seed).integers(lo, hi, (n, klen), np.uint8)


def _parts(path):
    """[(part name, decoded records)] of a local output dir."""
    out = []
    for name in sorted(os.listdir(path)):
        if name.startswith("part-"):
            with open(os.path.join(path, name), "rb") as f:
                out.append((name, list(jax_seq.Reader(f))))
    return out


def _counters(result):
    return {(g, n): v for g, names in result.counters.to_dict().items()
            for n, v in names.items() if not n.endswith("_MILLIS")}


# ---------------------------------------------------------- device sort


@pytest.mark.parametrize("lo,hi", [(0, 256), (0x41, 0x43)])
def test_key_columns_lex_gt_compute_dest_match_jax(lo, hi):
    """Mirrors tests/test_device_shuffle.py:39
    (test_key_columns_order_preserving) and :48
    (test_compute_dest_matches_host_partitioner): numpy columns, _lex_gt
    and destinations equal the JAX package's; the torch versions give the
    same values; destinations follow bisect_left over the cut keys."""
    keys = _keys(4, 300, lo, hi)
    cols = device_sort.key_columns(keys, 10)
    jcols = jax_device_sort.key_columns(keys, 10)
    assert cols.dtype == np.uint32
    np.testing.assert_array_equal(cols, jcols)
    tcols = device_sort.key_columns(torch.from_numpy(keys), 10)
    np.testing.assert_array_equal(tcols.numpy(), cols.astype(np.int64))
    cuts = sorted({bytes(keys[i]) for i in (10, 50, 99)})
    cut_arr = np.frombuffer(b"".join(cuts), np.uint8).reshape(-1, 10)
    scols = device_sort.key_columns(cut_arr, 10)
    for j in range(len(cuts)):
        np.testing.assert_array_equal(
            device_sort._lex_gt(cols, scols[j]),
            jax_device_sort._lex_gt(jcols, scols[j]))
    dest = device_sort.compute_dest(cols, scols)
    np.testing.assert_array_equal(dest,
                                  jax_device_sort.compute_dest(jcols, scols))
    tdest = device_sort.compute_dest(tcols, torch.from_numpy(
        scols.astype(np.int64)))
    np.testing.assert_array_equal(tdest.numpy(), dest)
    assert [int(d) for d in dest] == [bisect.bisect_left(cuts, bytes(k))
                                      for k in keys]


@pytest.mark.parametrize("case", ["duplicates", "high_bytes", "short_key"])
def test_argsort_equals_np_lexsort(case):
    """Mirrors tests/test_device_shuffle.py:282
    (test_device_partition_sort_single_device_mesh): the stable torch
    argsort gives np.lexsort's permutation (and the JAX package's
    jitted argsort's) on keys with many repeats and on keys with bytes
    >= 0x80, which must sort after printable keys as raw bytes do."""
    klen = 10
    if case == "duplicates":
        keys = _keys(7, 5000, 0x41, 0x43)
        keys[::5] = keys[1]
    elif case == "high_bytes":
        keys = _keys(8, 4000, 0x20, 0x7F)
        keys[::3, 0] = np.random.default_rng(9).integers(0x80, 256, 1334)
        keys[1::7] = keys[0]
    else:
        klen = 5
        keys = _keys(10, 3000, 0, 4, klen)
    cols = device_sort.key_columns(keys, klen)
    want = np.lexsort(tuple(cols[:, c] for c in range(cols.shape[1] - 1,
                                                         -1, -1)))
    order, dev_cols = device_sort.device_partition_sort(
        cols, torch.device("cpu"))
    np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(
        order, np.asarray(jax_device_sort._argsort_keys(cols.shape[1])(cols)))
    assert sorted(map(bytes, keys)) == [bytes(keys[i]) for i in order]
    np.testing.assert_array_equal(dev_cols.numpy(), cols.astype(np.int64))
    if case == "high_bytes":
        high = keys[order][:, 0] >= 0x80
        assert high.any() and not high[:np.argmax(high)].any()
        assert high[np.argmax(high):].all()


# ---------------------------------------------------------- teragen


def test_teragen_records_match_jax(tmp_path):
    """tpumr/examples/terasort.py::gen_records and teragen: the same
    records, map by map."""
    for start, n in ((0, 7), (123, 1000), (10 ** 9, 33)):
        for a, b in zip(terasort.gen_records(start, n),
                        jax_terasort.gen_records(start, n)):
            np.testing.assert_array_equal(a, b)
    assert cli(["examples", "teragen", "1000", f"file://{tmp_path}/p",
                "-m", "3"] + CPU) == 0
    assert jax_cli(["examples", "teragen", "1000", f"file://{tmp_path}/j",
                    "-m", "3"]) == 0
    port, jax = _parts(tmp_path / "p"), _parts(tmp_path / "j")
    assert port == jax and len(port) == 3
    assert sum(len(r) for _, r in port) == 1000
    assert not os.path.exists(f"{tmp_path}/p.teragen-in")


def _dup_input(path, n=3000, maps=3):
    """`maps` SequenceFiles of n 10+90-byte records whose keys repeat
    (two letters, and some rows with a byte >= 0x80), each value naming
    its row, so the order of equal keys shows."""
    keys = _keys(11, n, 0x41, 0x43)
    keys[::9, 3] = 0xF0
    rows = np.concatenate([keys, np.full((n, 90), ord("."), np.uint8)], 1)
    rows[:, 10:20] = np.frombuffer(
        b"".join(b"%010d" % i for i in range(n)), np.uint8).reshape(n, 10)
    os.makedirs(path)
    for m, part in enumerate(np.array_split(rows, maps)):
        with open(os.path.join(path, f"part-{m:05d}"), "wb") as f:
            w = jax_seq.Writer(f, block_records=100)
            w.append_fixed_rows(part, 10)
            w.close()


@pytest.mark.parametrize("data", ["teragen", "duplicates"])
@pytest.mark.parametrize("shuffle", ["device", "host"])
def test_terasort_matches_jax_part_for_part(tmp_path, data, shuffle):
    """Mirrors tests/test_device_shuffle.py::test_terasort_device_shuffle_
    local and tests/test_examples.py::test_teragen_terasort_teravalidate:
    the same input through both packages' make_terasort_conf and local
    runner, 5 reduces, with the device or the host shuffle. The part
    files hold the same record sequences, part for part; the partition
    file is byte-identical; the counters both packages keep are equal key
    by key (*_MILLIS aside)."""
    gen = f"{tmp_path}/gen"
    if data == "teragen":
        assert jax_cli(["examples", "teragen", "2000", f"file://{gen}",
                        "-m", "3"]) == 0
        n = 2000
    else:
        _dup_input(gen)
        n = 3000
    device = shuffle == "device"
    conf = terasort.make_terasort_conf(f"file://{gen}",
                                       f"file://{tmp_path}/p", 5, device)
    jconf = jax_terasort.make_terasort_conf(f"file://{gen}",
                                            f"file://{tmp_path}/j", 5,
                                            device)
    result, jresult = run_job(conf, device="cpu"), jax_run_job(jconf)
    assert result.successful and jresult.successful
    port, jax = _parts(tmp_path / "p"), _parts(tmp_path / "j")
    assert [p for p, _ in port] == [f"part-{r:05d}" for r in range(5)]
    assert port == jax
    records = [kv for _, recs in port for kv in recs]
    assert len(records) == n
    assert [k for k, _ in records] == sorted(k for k, _ in records)
    with open(f"{tmp_path}/p.partitions", "rb") as f, \
            open(f"{tmp_path}/j.partitions", "rb") as g:
        assert f.read() == g.read()
    got, want = _counters(result), _counters(jresult)
    shared = got.keys() & want.keys()
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    tsr = (BackendCounter.GROUP, BackendCounter.TPU_SHUFFLE_RECORDS)
    out = (TaskCounter.FRAMEWORK_GROUP, TaskCounter.REDUCE_OUTPUT_RECORDS)
    assert out in shared and got[out] == n
    if device:
        assert got[tsr] == n
        assert (BackendCounter.GROUP,
                BackendCounter.DEVICE_SORT_ON_ACCEL) not in got   # the CPU
        assert result.num_reduces == 1 and result.reduce_stages["records"] \
            == n
    else:
        assert tsr not in got


# ------------------------------------------- device shuffle, edge cases


class FixedKeyMapper:
    """tests/test_device_shuffle.py's: (7-byte key, 4-byte count 1) per
    non-blank line."""

    def configure(self, conf):
        pass

    def map(self, key, value, output, reporter):
        line = value if isinstance(value, (bytes, bytearray)) else \
            str(value).encode()
        if line.strip():
            output.collect(bytes(line.strip()[:7]), (1).to_bytes(4, "big"))

    def close(self):
        pass


class FixedCountReducer:
    """Sums 4-byte big-endian counts into a 4-byte value."""

    def configure(self, conf):
        pass

    def reduce(self, key, values, output, reporter):
        total = sum(int.from_bytes(v, "big") for v in values)
        output.collect(key, total.to_bytes(4, "big"))

    def close(self):
        pass


class DroppingIdentitySubclass(IdentityMapper):
    """Inherits identity_map but overrides map() to keep even rows."""

    def map(self, key, value, output, reporter):
        line = value if isinstance(value, (bytes, bytearray)) else \
            str(value).encode()
        if int(line[-1:] or b"0", 10) % 2 == 0:
            output.collect(bytes(line.strip()[:7]), b"")


def _mem_job(name, text, mapper, reduces, widths, reducer=None):
    FileSystem.get("mem:///").write_bytes(f"/{name}/in.txt", text)
    conf = JobConf()
    conf.set_input_paths(f"mem:///{name}/in.txt")
    conf.set_output_path(f"mem:///{name}/out")
    conf.set_mapper_class(mapper)
    if reducer is not None:
        conf.set_reducer_class(reducer)
    conf.set_output_format(SequenceFileOutputFormat)
    conf.set_num_reduce_tasks(reduces)
    conf.set_device_shuffle(*widths)
    return conf


def _mem_parts(name):
    fs = FileSystem.get("mem:///")
    out = []
    for st in sorted(fs.list_files(f"/{name}/out"), key=lambda s: str(s.path)):
        if st.path.name.startswith("part-"):
            out.append(list(sequencefile.Reader(io.BytesIO(
                fs.read_bytes(st.path)))))
    return out


def test_device_shuffle_with_a_real_reducer():
    """Mirrors tests/test_device_shuffle.py:118: a reducer other than the
    identity runs over each range's sorted rows, a group per key."""
    conf = _mem_job("dsr", b"\n".join(b"key%04d" % (i % 7)
                                      for i in range(210)),
                    FixedKeyMapper, 3, (7, 4), FixedCountReducer)
    result = run_job(conf, device="cpu")
    parts = _mem_parts("dsr")
    assert len(parts) == 3
    counts = {bytes(k): int.from_bytes(v, "big") for p in parts for k, v in p}
    assert counts == {b"key%04d" % i: 30 for i in range(7)}
    assert result.counters.value(TaskCounter.FRAMEWORK_GROUP,
                                 TaskCounter.REDUCE_INPUT_GROUPS) == 7


def test_identity_subclass_overriding_map_is_not_bypassed():
    """Mirrors tests/test_device_shuffle.py:143."""
    conf = _mem_job("dsi", b"\n".join(b"key%04d" % i for i in range(20)),
                    DroppingIdentitySubclass, 1, (7, 0))
    assert run_job(conf, device="cpu").successful
    assert sum(len(p) for p in _mem_parts("dsi")) == 10


def test_duplicate_heavy_input_short_cut_list():
    """Mirrors tests/test_device_shuffle.py:163: 16 ranges over two keys
    (cuts sampled from the keys, many equal); every range the JAX
    package's job leaves empty is empty here too."""
    from tpumr.fs.filesystem import FileSystem as JaxFileSystem
    from tpumr.mapred.jobconf import JobConf as JaxJobConf
    from tpumr.mapred.output_formats import \
        SequenceFileOutputFormat as JaxSeqOutputFormat
    text = b"\n".join(b"dup%04d" % (i % 2) for i in range(100))
    conf = _mem_job("dsd", text, FixedKeyMapper, 16, (7, 4))
    assert run_job(conf, device="cpu").successful
    parts = _mem_parts("dsd")
    assert len(parts) == 16
    keys = [k for p in parts for k, _ in p]
    assert len(keys) == 100 and keys == sorted(keys)
    jfs = JaxFileSystem.get("mem:///")
    jfs.write_bytes("/dsd/in.txt", text)
    jconf = JaxJobConf()
    jconf.set_input_paths("mem:///dsd/in.txt")
    jconf.set_output_path("mem:///dsd/out")
    jconf.set_mapper_class(FixedKeyMapper)
    jconf.set_output_format(JaxSeqOutputFormat)
    jconf.set_num_reduce_tasks(16)
    jconf.set_device_shuffle(7, 4)
    assert jax_run_job(jconf).successful
    jparts = [list(jax_seq.Reader(io.BytesIO(jfs.read_bytes(st.path))))
              for st in sorted(jfs.list_files("/dsd/out"),
                               key=lambda s: str(s.path))
              if st.path.name.startswith("part-")]
    assert parts == jparts


def test_custom_comparator_rejected():
    """Mirrors tests/test_device_shuffle.py:185."""
    conf = JobConf()
    conf.set_num_reduce_tasks(2)
    conf.set_device_shuffle(10, 4)
    conf.set_output_key_comparator_class(DeserializingComparator)
    with pytest.raises(ValueError, match="comparator"):
        prepare_device_shuffle_job(conf)


def test_wrong_width_fails_with_clear_error():
    """Mirrors tests/test_device_shuffle.py:197."""
    conf = _mem_job("dsw", b"hello world\n", FixedKeyMapper, 1, (10, 4))
    with pytest.raises(ValueError, match="10-byte keys"):
        run_job(conf, device="cpu")


# ---------------------------------------------------------- teravalidate


def test_teragen_terasort_teravalidate_cli(tmp_path, capsys):
    """Mirrors tests/test_examples.py:22: the three programs through the
    port's CLI, the sort on the device path (on the CPU here)."""
    base = f"file://{tmp_path}"
    assert cli(["examples", "teragen", "1000", f"{base}/gen", "-m", "3"]
               + CPU) == 0
    assert cli(["examples", "terasort", f"{base}/gen", f"{base}/sorted",
                "-r", "3", "--device-shuffle"] + CPU) == 0
    out = [kv for _, recs in _parts(tmp_path / "sorted") for kv in recs]
    assert len(out) == 1000
    assert [k for k, _ in out] == sorted(k for k, _ in out)
    assert sorted(v[:10] for _, v in out)[-1] == b"0000000999"
    assert cli(["examples", "teravalidate", f"{base}/sorted",
                f"{base}/report"] + CPU) == 0
    assert "globally sorted" in capsys.readouterr().out


def test_teravalidate_catches_misorder(tmp_path, capsys):
    """Mirrors tests/test_examples.py:44: an inverted pair inside a part
    and across a boundary."""
    for name, keys in (("part-00000", [b"zzz", b"aaa"]),
                       ("part-00001", [b"a"])):
        os.makedirs(tmp_path / "bad", exist_ok=True)
        with open(tmp_path / "bad" / name, "wb") as f:
            w = sequencefile.Writer(f)
            for k in keys:
                w.append(k, b"x")
            w.close()
    assert cli(["examples", "teravalidate", f"file://{tmp_path}/bad",
                f"file://{tmp_path}/report"] + CPU) == 1
    out = capsys.readouterr().out
    assert "FAILED" in out and "misordered-in-part" in out \
        and "misordered-across-parts" in out


@pytest.mark.parametrize("keys", [
    [b"a", b"ab", b"b"], [b"ab", b"a"], [b"ab", b"ab\x00"],
    [b"ab\x00", b"ab"], [b"a\x00b", b"a\x00a"], [b"a\x00a", b"a\x00b"],
    [b"x" * 10, b"x" * 9 + b"y", b"z"], [b"k", b"k", b"k"],
    [b"", b"", b""]])
def test_batch_order_check_matches_per_record(keys):
    """Mirrors tests/test_examples.py:125: map_record_batch counts the
    inversions map() counts, in Python's bytes order."""
    expect = sum(1 for i in range(1, len(keys)) if keys[i] < keys[i - 1])
    got = {}
    for how in ("batch", "record"):
        m = terasort.TeraValidateMapper()
        m.configure(JobConf())
        out = []
        collector = OutputCollector(lambda k, v: out.append((k, v)))
        if how == "batch":
            m.map_record_batch(RecordBatch.from_pairs(
                [(k, b"v") for k in keys]), collector, None)
        else:
            for k in keys:
                m.map(k, b"v", collector, None)
        m.close()
        got[how] = out
    ordinal, (first, last, errors) = got["batch"][0]
    assert errors == expect and got["batch"] == got["record"]
    assert first == keys[0] and last == keys[-1]


def test_terasort_asked_for_cuda_without_it_raises(tmp_path):
    """No CUDA and no CPU asked for: the job raises, by design."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    assert cli(["examples", "teragen", "100", f"file://{tmp_path}/gen"]
               + CPU) == 0
    for device_shuffle in (True, False):
        conf = terasort.make_terasort_conf(f"file://{tmp_path}/gen",
                                           f"file://{tmp_path}/o", 2,
                                           device_shuffle)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_job(conf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli(["examples", "terasort", f"file://{tmp_path}/gen",
             f"file://{tmp_path}/o2", "--device-shuffle"])
