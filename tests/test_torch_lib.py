"""The port's old-API helper library (tpumr_torch.mapred.lib), the input
formats it brings (KeyValueText, BytesText, WholeFile, CombineFile with
MultiFileSplit) and the map-side commit of named outputs in jobs with
reduces, each against the JAX package's on the same inputs.

Each test mirrors one of tests/test_lib.py (named in its docstring) and
runs the same seeded input through both packages' LocalJobRunner, the port
with tpumr_torch.device=cpu; part files and side files are compared byte
for byte. The user classes here are plain classes (configure, map or
reduce, close), so that one class serves both packages.
"""

import os
import random

import numpy as np
import pytest

from tpumr.io.writable import serialize as jax_serialize
from tpumr.mapred import api as jax_api
from tpumr.mapred import input_formats as jax_if
from tpumr.mapred import lib as jax_lib
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr.mapred.split import InputSplit as JaxInputSplit
from tpumr_torch.io.writable import serialize
from tpumr_torch.mapred import input_formats as port_if
from tpumr_torch.mapred import lib
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.mapred.split import InputSplit

PKGS = {"jax": (JaxJobConf, jax_lib, jax_if, jax_run_job),
        "port": (JobConf, lib, port_if, run_job)}


def _words(seed: int, lines: int, per_line: int = 6, vocab: int = 40) -> bytes:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(lines, per_line))
    return b"".join((" ".join(f"w{i:02d}" for i in row) + "\n").encode()
                    for row in ids)


def _run(pkg: str, tmp_path, name: str, setup, reduces: int = 1):
    """One job in ``pkg`` whose output goes to ``tmp_path/name-pkg``; the
    output directory's files (name -> bytes) and the result."""
    conf_cls, mod, fmts, runner = PKGS[pkg]
    conf = conf_cls()
    if pkg == "port":
        conf.set("tpumr_torch.device", "cpu")
    out = tmp_path / f"{name}-{pkg}"
    conf.set_output_path(f"file://{out}")
    conf.set_num_reduce_tasks(reduces)
    setup(conf, mod, fmts)
    result = runner(conf)
    assert result.successful
    return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))
            if not f.startswith(("_", "."))}, result


def _both(tmp_path, name, setup, reduces=1):
    jax_files, jax_result = _run("jax", tmp_path, name, setup, reduces)
    port_files, port_result = _run("port", tmp_path, name, setup, reduces)
    assert port_files == jax_files
    return port_files, port_result, jax_result


class _Plain:
    def configure(self, conf):
        pass

    def close(self):
        pass


class SumReducer(_Plain):
    def reduce(self, key, values, output, reporter):
        output.collect(key, sum(values))


class SplitMapper(_Plain):
    def map(self, key, value, output, reporter):
        a, b = str(value).split()
        output.collect(a, int(b))


class DoubleMapper(_Plain):
    def map(self, key, value, output, reporter):
        output.collect(key, value * 2)


class UpperMapper(_Plain):
    def map(self, key, value, output, reporter):
        output.collect(str(key).upper(), value)


class CsvMapper(_Plain):
    def map(self, key, value, output, reporter):
        k, n = str(value).split(",")
        output.collect(k, int(n))


class TsvMapper(_Plain):
    def map(self, key, value, output, reporter):
        k, n = str(value).split("\t")
        output.collect(k, int(n))


class LineKeyMapper(_Plain):
    def map(self, key, value, output, reporter):
        output.collect(str(value), 1)


class Router(_Plain):
    """Lines "bad N" to the side output "rejected", others to the main
    output (tests/test_lib.py's Router)."""

    MO = None

    def configure(self, conf):
        self._conf = conf
        self._mo = None

    def map(self, key, value, output, reporter):
        if self._mo is None:
            self._mo = self.MO(self._conf)
        tag, n = str(value).split()
        if tag == "bad":
            self._mo.collector("rejected").collect(tag, n)
        else:
            output.collect(tag, int(n))

    def close(self):
        if self._mo is not None:
            self._mo.close()


class PortRouter(Router):
    MO = lib.MultipleOutputs


class JaxRouter(Router):
    MO = jax_lib.MultipleOutputs


class AggEmit(_Plain):
    def map(self, key, value, output, reporter):
        word, n = str(value).split()
        output.collect(f"LongValueSum:{word}", int(n))
        output.collect(f"LongValueMax:max-{word}", int(n))
        output.collect(f"DoubleValueSum:d-{word}", int(n) / 4)
        output.collect(f"StringValueMin:first-{word[0]}", word)
        output.collect("UniqValueCount:words", word)
        output.collect("ValueHistogram:lens", len(word))


@pytest.mark.parametrize("mapper", ["TokenCountMapper", "RegexMapper"])
def test_token_count_and_regex_mappers(tmp_path, mapper):
    """tests/test_lib.py::test_token_count_and_regex_mappers."""
    (tmp_path / "in.txt").write_bytes(_words(1, 300))

    def setup(conf, mod, fmts):
        conf.set_input_paths(f"file://{tmp_path}/in.txt")
        conf.set_mapper_class(getattr(mod, mapper))
        conf.set("mapred.mapper.regex", r"w(0\d)")
        conf.set("mapred.mapper.regex.group", 1)
        conf.set_reducer_class(SumReducer)
    files, _, _ = _both(tmp_path, "tok", setup)
    assert files["part-00000"].count(b"\n") == (40 if mapper ==
                                                "TokenCountMapper" else 10)


def test_field_selection(tmp_path):
    """tests/test_lib.py::test_field_selection."""
    rng = np.random.default_rng(2)
    (tmp_path / "in.txt").write_bytes(b"".join(
        f"u{a}\tS{b}\t{c}\tx{d}\n".encode()
        for a, b, c, d in rng.integers(0, 9, size=(200, 4))))

    def setup(conf, mod, fmts):
        conf.set_input_paths(f"file://{tmp_path}/in.txt")
        conf.set_mapper_class(mod.FieldSelectionMapReduce)
        conf.set_reducer_class(mod.FieldSelectionMapReduce)
        conf.set("mapred.text.key.value.fields.spec", "0,1:2-")
    files, _, _ = _both(tmp_path, "fs", setup)
    assert files["part-00000"].count(b"\n") == 200


@pytest.mark.parametrize("opts", ["-k2,2nr -k1,1", "-k2", "-k3n -k1,1r", ""])
def test_key_field_based_comparator_orders_as_the_reference(opts):
    """tests/test_lib.py::test_key_field_based_comparator: the same order
    of the same keys under each option string."""
    rnd = random.Random(3)
    keys = [f"{rnd.choice('abc')}\t{rnd.randint(0, 12)}\t"
            f"{rnd.choice(['x', '7', '1.5'])}" for _ in range(60)]

    def order(conf_cls, comparator, ser):
        conf = conf_cls()
        conf.set("mapred.text.key.comparator.options", opts)
        c = comparator(conf)
        return sorted(keys, key=lambda k: c.sort_key(ser(k)))

    assert order(JobConf, lib.KeyFieldBasedComparator, serialize) == \
        order(JaxJobConf, jax_lib.KeyFieldBasedComparator, jax_serialize)


def test_key_field_comparator_refuses_char_offsets():
    """tests/test_lib.py::test_key_field_based_comparator's char offsets."""
    conf = JobConf()
    conf.set("mapred.text.key.comparator.options", "-k1.3,1.5")
    with pytest.raises(ValueError, match="char offsets"):
        lib.KeyFieldBasedComparator(conf)


def test_key_field_comparator_sorts_a_job(tmp_path):
    """tests/test_lib.py::test_key_field_based_comparator, end to end."""
    (tmp_path / "in.txt").write_bytes(b"b\t2\na\t10\nc\t10\na\t1\n")

    def setup(conf, mod, fmts):
        conf.set_input_paths(f"file://{tmp_path}/in.txt")
        conf.set_mapper_class(LineKeyMapper)
        conf.set_output_key_comparator_class(mod.KeyFieldBasedComparator)
        conf.set("mapred.text.key.comparator.options", "-k2,2nr -k1,1")
    files, _, _ = _both(tmp_path, "kfc", setup)
    assert files["part-00000"] == b"a\t10\t1\nc\t10\t1\nb\t2\t1\na\t1\t1\n"


def test_chain_mapper_and_reducer(tmp_path):
    """tests/test_lib.py::test_chain_mapper_and_reducer."""
    rng = np.random.default_rng(4)
    (tmp_path / "in.txt").write_bytes(b"".join(
        f"k{a} {b}\n".encode() for a, b in rng.integers(0, 20, (300, 2))))

    def setup(conf, mod, fmts):
        conf.set_input_paths(f"file://{tmp_path}/in.txt")
        mod.ChainMapper.add_mapper(conf, SplitMapper)
        mod.ChainMapper.add_mapper(conf, DoubleMapper)
        mod.ChainReducer.set_reducer(conf, SumReducer)
        mod.ChainReducer.add_mapper(conf, UpperMapper)
    files, _, _ = _both(tmp_path, "chain", setup)
    assert files["part-00000"].startswith(b"K0\t")


def test_multiple_inputs_routes_by_path(tmp_path):
    """tests/test_lib.py::test_multiple_inputs_routes_by_path."""
    (tmp_path / "csv").mkdir()
    (tmp_path / "tsv").mkdir()
    (tmp_path / "csv" / "a.txt").write_bytes(b"k,1\nj,2\nk,2\n")
    (tmp_path / "tsv" / "b.txt").write_bytes(b"k\t3\nj\t9\n")

    def setup(conf, mod, fmts):
        mod.MultipleInputs.add_input_path(conf, f"file://{tmp_path}/csv",
                                          CsvMapper)
        mod.MultipleInputs.add_input_path(conf, f"file://{tmp_path}/tsv",
                                          TsvMapper)
        conf.set_reducer_class(SumReducer)
    files, _, _ = _both(tmp_path, "mi", setup)
    assert files["part-00000"] == b"j\t11\nk\t6\n"


@pytest.mark.parametrize("reduces", [0, 1])
def test_multiple_outputs_side_files_follow_commit(tmp_path, reduces):
    """tests/test_lib.py::test_multiple_outputs_side_files_follow_commit:
    map-only, and with a reduce, where the map attempt's side file is
    committed beside the reduce's part file."""
    rng = np.random.default_rng(5)
    (tmp_path / "in.txt").write_bytes(b"".join(
        f"{'bad' if b else 'good'} {n}\n".encode()
        for b, n in zip(rng.integers(0, 2, 100), rng.integers(0, 50, 100))))

    def setup(conf, mod, fmts):
        conf.set_input_paths(f"file://{tmp_path}/in.txt")
        conf.set_mapper_class(PortRouter if mod is lib else JaxRouter)
        if reduces:
            conf.set_reducer_class(SumReducer)
    files, _, _ = _both(tmp_path, f"mo{reduces}", setup, reduces=reduces)
    assert sorted(files) == ["part-00000", "rejected-00000"]
    for bad in ("../escape", "part"):
        with pytest.raises(ValueError, match="bad MultipleOutputs"):
            lib.MultipleOutputs(JobConf()).collector(bad)


def test_key_field_based_partitioner():
    """tests/test_lib.py::test_key_field_based_partitioner: the same
    partition of every key as the JAX package's."""
    p = lib.KeyFieldBasedPartitioner(num_fields=2)
    q = jax_api.KeyFieldBasedPartitioner(num_fields=2)
    keys = [f"u{i % 13}\tS{i % 5}\textra{i}" for i in range(200)]
    assert [p.get_partition(k, None, 16) for k in keys] == \
        [q.get_partition(k, None, 16) for k in keys]
    assert p.get_partition("u1\tWA\ta", None, 16) == \
        p.get_partition("u1\tWA\tb", None, 16)


def test_aggregate_framework(tmp_path):
    """tests/test_lib.py::test_aggregate_framework, with every
    aggregator."""
    rng = np.random.default_rng(6)
    words = ["apple", "pear", "fig", "plum"]
    (tmp_path / "in.txt").write_bytes(b"".join(
        f"{words[w]} {n}\n".encode()
        for w, n in zip(rng.integers(0, 4, 150), rng.integers(0, 99, 150))))

    def setup(conf, mod, fmts):
        conf.set_input_paths(f"file://{tmp_path}/in.txt")
        conf.set_mapper_class(AggEmit)
        conf.set_reducer_class(mod.ValueAggregatorReducer)
        conf.set_combiner_class(mod.ValueAggregatorCombiner)
        conf.set("io.sort.mb", 1)
        conf.set("io.sort.spill.percent", 0.002)
    files, _, _ = _both(tmp_path, "agg", setup)
    got = dict(l.split("\t") for l in
               files["part-00000"].decode().splitlines())
    assert got["words"] == "4" and got["lens"].startswith("3:")


# ------------------------------------------------------------ input formats


class EchoMapper(_Plain):
    def map(self, key, value, output, reporter):
        output.collect(key, value)


@pytest.mark.parametrize("sep", ["\t", ",", ""])
def test_key_value_text_input_format(tmp_path, sep):
    """tests/test_input_formats.py's KeyValueTextInputFormat: lines split
    at the separator's first byte (TAB when empty), lines without it keyed
    whole."""
    (tmp_path / "in.txt").write_bytes(
        b"a\tb,c\nno separator here\nx,y\tz\n\tlead\n")

    def setup(conf, mod, fmts):
        conf.set_input_paths(f"file://{tmp_path}/in.txt")
        conf.set_input_format(fmts.KeyValueTextInputFormat)
        conf.set("key.value.separator.in.input.line", sep)
        conf.set_mapper_class(EchoMapper)
    _both(tmp_path, f"kv{len(sep)}{sep == ','}", setup, reduces=0)


def test_bytes_text_and_whole_file_formats(tmp_path):
    """tests/test_input_formats.py: BytesTextInputFormat's values stay
    bytes; WholeFileInputFormat reads one record a file, never split."""
    (tmp_path / "d").mkdir()
    for i in range(3):
        (tmp_path / "d" / f"f{i}.bin").write_bytes(
            np.random.default_rng(i).integers(0, 256, 3000, np.uint8)
            .tobytes())
    for pkg, (conf_cls, _mod, fmts, _run) in PKGS.items():
        conf = conf_cls()
        conf.set_input_paths(f"file://{tmp_path}/d")
        conf.set("mapred.max.split.size", 1000)
        whole = fmts.WholeFileInputFormat()
        splits = whole.get_splits(conf, 4)
        assert [s.split_length for s in splits] == [3000] * 3
        recs = [r for s in splits for r in whole.get_record_reader(s, conf)]
        assert [v for _, v in recs] == [
            (tmp_path / "d" / f"f{i}.bin").read_bytes() for i in range(3)]
    (tmp_path / "t.txt").write_bytes(b"caf\xc3\xa9\n\xff\xfe\nplain\n")
    got = {}
    for pkg, (conf_cls, _mod, fmts, _run) in PKGS.items():
        conf = conf_cls()
        conf.set_input_paths(f"file://{tmp_path}/t.txt")
        fmt = fmts.BytesTextInputFormat()
        got[pkg] = [r for s in fmt.get_splits(conf, 1)
                    for r in fmt.get_record_reader(s, conf)]
    assert got["port"] == got["jax"] == [
        (0, b"caf\xc3\xa9"), (6, b"\xff\xfe"), (9, b"plain")]


def test_combine_file_input_format(tmp_path):
    """tests/test_input_formats.py's CombineFileInputFormat: the same
    MultiFileSplits, records and batches as the JAX package's."""
    (tmp_path / "small").mkdir()
    for i in range(7):
        (tmp_path / "small" / f"p{i}.txt").write_bytes(_words(10 + i, 5 + i))
    got = {}
    for pkg, (conf_cls, _mod, fmts, _run) in PKGS.items():
        conf = conf_cls()
        conf.set_input_paths(f"file://{tmp_path}/small")
        conf.set("mapred.max.split.size", 400)
        fmt = fmts.CombineFileInputFormat()
        splits = fmt.get_splits(conf, 2)
        batches = [fmt.read_batch(s, conf) for s in splits]
        got[pkg] = ([[tuple(p) for p in s.parts] for s in splits],
                    [list(fmt.get_record_reader(s, conf)) for s in splits],
                    [b.value_data.tobytes() for b in batches],
                    [b.value_offsets.tolist() for b in batches])
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) > 1


def test_multi_file_split_and_db_split_survive_each_wire_form():
    """MultiFileSplit and DBSplit through each package's
    InputSplit.to_dict / from_dict: the same fields either side."""
    from tpumr.mapred.lib_db import DBSplit as JaxDBSplit
    from tpumr_torch.mapred.lib_db import DBSplit
    parts = [("file:///a", 0, 10), ("file:///b", 0, 20)]
    for split, from_dict in ((port_if.MultiFileSplit(["h1"], parts=parts),
                              InputSplit.from_dict),
                             (jax_if.MultiFileSplit(["h1"], parts=parts),
                              JaxInputSplit.from_dict),
                             (DBSplit(25, 50), InputSplit.from_dict),
                             (JaxDBSplit(25, 50), JaxInputSplit.from_dict)):
        back = from_dict(split.to_dict())
        assert type(back) is type(split)
        assert back.__dict__ == split.__dict__ and back.length == split.length
    strip = (lambda d: {k: v for k, v in d.items() if k != "type"})
    assert strip(port_if.MultiFileSplit(["h1"], parts=parts).to_dict()) == \
        strip(jax_if.MultiFileSplit(["h1"], parts=parts).to_dict())
    assert strip(DBSplit(25, 50).to_dict()) == \
        strip(JaxDBSplit(25, 50).to_dict())


# ---------------------------------------------------------- on a cluster

#: the cluster job's classes, in a module a fresh child can import without
#: this test module (which loads the JAX package)
CLUSTER_MODULE = "torch_lib_cluster_classes"
CLUSTER_CLASSES = """
from tpumr_torch.mapred.lib import MultipleOutputs


class CsvMapper:
    def configure(self, conf):
        pass

    def map(self, key, value, output, reporter):
        k, n = str(value).split(",")
        output.collect(k, int(n))

    def close(self):
        pass


class SideTsvMapper:
    def configure(self, conf):
        self._mo = MultipleOutputs(conf)

    def map(self, key, value, output, reporter):
        k, n = str(value).split("\\t")
        if k == "bad":
            self._mo.collector("bad").collect(k, n)
        else:
            output.collect(k, int(n))

    def close(self):
        self._mo.close()


class SumReducer:
    def configure(self, conf):
        pass

    def reduce(self, key, values, output, reporter):
        output.collect(key, sum(values))

    def close(self):
        pass
"""


@pytest.fixture(scope="module")
def cluster_classes(tmp_path_factory):
    import importlib
    import sys
    d = tmp_path_factory.mktemp("classes")
    (d / f"{CLUSTER_MODULE}.py").write_text(CLUSTER_CLASSES)
    sys.path.insert(0, str(d))
    try:
        yield importlib.import_module(CLUSTER_MODULE)
    finally:
        sys.path.remove(str(d))
        sys.modules.pop(CLUSTER_MODULE, None)


@pytest.mark.parametrize("isolation", ["thread", "process"])
def test_input_path_and_side_files_on_a_cluster(tmp_path, cluster_classes,
                                                isolation):
    """tests/test_lib.py's MultipleInputs and MultipleOutputs on the port's
    mini cluster: tpumr.task.input.path reaches DelegatingMapper before
    it is built, in the runner's thread and in an isolated child, and the
    node runner commits a map's side file in a job with a reduce."""
    from tpumr_torch.mapred.job_client import JobClient
    (tmp_path / "csv").mkdir()
    (tmp_path / "tsv").mkdir()
    (tmp_path / "csv" / "a.txt").write_bytes(b"k,1\nj,2\n")
    (tmp_path / "tsv" / "b.txt").write_bytes(b"k\t3\nbad\t9\n")
    c = JobConf()
    c.set("tpumr_torch.device", "cpu")
    c.set("tpumr.heartbeat.interval.ms", 20)
    with MiniMRCluster(num_trackers=1, cpu_slots=2, tpu_slots=0,
                       conf=c) as cluster:
        conf = cluster.create_job_conf()
        conf.set("tpumr.task.isolation", isolation)
        conf.set_output_path(f"file://{tmp_path}/out")
        lib.MultipleInputs.add_input_path(conf, f"file://{tmp_path}/csv",
                                          cluster_classes.CsvMapper)
        lib.MultipleInputs.add_input_path(conf, f"file://{tmp_path}/tsv",
                                          cluster_classes.SideTsvMapper)
        conf.set_reducer_class(cluster_classes.SumReducer)
        conf.set_num_reduce_tasks(1)
        client = JobClient(conf)
        try:
            st = client.submit_job(conf).wait_for_completion(timeout=60)
        finally:
            client.close()
        assert st["state"] == "SUCCEEDED", st
    assert (tmp_path / "out" / "part-00000").read_bytes() == b"j\t2\nk\t4\n"
    assert (tmp_path / "out" / "bad-00001").read_bytes() == b"bad\t9\n"
