"""The port's examples randomwriter, sort, secondarysort and join
(tpumr_torch/examples/{random_writer,sort,secondary_sort,join}.py), and
compressed map output through its mini cluster, against the JAX package's
programs on the same inputs made from numpy seeds.

Oracles: tests/test_examples.py::TestSortAndRandomWriter, ::TestSecondarySort
and ::TestJoin, run here through both packages' CLIs. SequenceFile parts are
compared as decoded records (each writer draws its own sync marker), text
parts and the partition file byte for byte. The port's programs run on the
CPU (-D tpumr_torch.device=cpu).
"""

import os

import numpy as np
import pytest

from tpumr.cli import main as jax_cli
from tpumr.io import sequencefile as jax_sequencefile
from tpumr.mapred.job_client import JobClient as JaxJobClient
from tpumr.mapred.mini_cluster import MiniMRCluster as JaxMiniMRCluster
from tpumr_torch.cli import main as cli
from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io import sequencefile
from tpumr_torch.mapred.job_client import JobClient
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.mini_cluster import MiniMRCluster

CPU = ["-D", f"{DEVICE_KEY}=cpu"]
#: a map buffer that spills every few records, and a merge of 3 at most
SPILLY = ["-D", "io.sort.mb=1", "-D", "io.sort.spill.percent=0.002",
          "-D", "io.sort.factor=3"]
#: seconds a cluster job may take here
JOB_TIMEOUT = 60


@pytest.fixture(autouse=True)
def _fresh_mem():
    FileSystem.clear_cache()
    yield
    FileSystem.clear_cache()


def seq_records(path, reader=sequencefile.Reader):
    recs = []
    for name in sorted(os.listdir(path)):
        if name.startswith("part-"):
            with open(os.path.join(path, name), "rb") as f:
                recs.append(list(reader(f)))
    return recs


def text_parts(path):
    return {n: (path / n).read_bytes() for n in sorted(os.listdir(path))
            if n.startswith("part-")}


def test_randomwriter_records_equal_jax(tmp_path):
    """tpumr/examples/random_writer.py from the same seeds (1234 + map):
    the same records in each part file, read by either package's reader."""
    assert cli(["examples", "randomwriter", f"file://{tmp_path}/rw", "-m",
                "2", "--bytes-per-map", "20000"] + CPU) == 0
    assert jax_cli(["examples", "randomwriter", f"file://{tmp_path}/jrw",
                    "-m", "2", "--bytes-per-map", "20000"]) == 0
    got = seq_records(tmp_path / "rw")
    assert got == seq_records(tmp_path / "jrw")
    assert got == seq_records(tmp_path / "rw", jax_sequencefile.Reader)
    assert len(got) == 2
    for part in got:
        assert sum(len(k) + len(v) for k, v in part) >= 20000
        assert all(10 <= len(k) <= 100 and len(v) <= 1000 for k, v in part)
    assert not os.path.exists(tmp_path / "rw.rw-in")


def test_total_order_sort_equals_jax(tmp_path):
    """tpumr/examples/sort.py --total-order over randomwriter's records:
    the partition file byte-identical, the parts record-identical and in
    order as a whole. The port's maps spill every few records and merge
    at io.sort.factor 3; the JAX package's run at its defaults."""
    assert cli(["examples", "randomwriter", f"file://{tmp_path}/data", "-m",
                "3", "--bytes-per-map", "30000"] + CPU) == 0
    assert cli(["examples", "sort", f"file://{tmp_path}/data",
                f"file://{tmp_path}/sorted", "-r", "2", "--total-order"]
               + CPU + SPILLY) == 0
    assert jax_cli(["examples", "sort", f"file://{tmp_path}/data",
                    f"file://{tmp_path}/jsorted", "-r", "2",
                    "--total-order"]) == 0
    assert (tmp_path / "sorted.partitions").read_bytes() == \
        (tmp_path / "jsorted.partitions").read_bytes()
    got = seq_records(tmp_path / "sorted")
    assert got == seq_records(tmp_path / "jsorted")
    flat = [kv for part in got for kv in part]
    inp = [kv for part in seq_records(tmp_path / "data") for kv in part]
    assert sorted(flat) == sorted(inp) and len(got) == 2
    keys = [k for k, _ in flat]
    assert keys == sorted(keys)


def _secondary_lines(seed):
    rng = np.random.default_rng(seed)
    lines = [f"{first} {int(second)}" for first in (3, 1, 2, 7, 5)
             for second in rng.permutation(30)]
    rng.shuffle(lines)
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("reduces", [1, 2])
def test_secondarysort_equals_jax(tmp_path, reduces):
    """tests/test_examples.py::TestSecondarySort through both CLIs: the
    text parts byte-identical, each group's seconds ascending."""
    (tmp_path / "in.txt").write_text(_secondary_lines(5))
    assert cli(["examples", "secondarysort", f"file://{tmp_path}/in.txt",
                f"file://{tmp_path}/out", "-r", str(reduces)]
               + CPU + SPILLY) == 0
    assert jax_cli(["examples", "secondarysort", f"file://{tmp_path}/in.txt",
                    f"file://{tmp_path}/jout", "-r", str(reduces)]) == 0
    got = text_parts(tmp_path / "out")
    assert got == text_parts(tmp_path / "jout") and len(got) == reduces
    lines = b"".join(got.values()).decode().splitlines()
    assert sorted(int(line.split("\t")[0]) for line in lines) == \
        [1, 2, 3, 5, 7]
    assert all(line.split("\t")[1] == str(list(range(30))) for line in lines)


@pytest.mark.parametrize("outer", [False, True])
def test_join_equals_jax(tmp_path, outer):
    """tests/test_examples.py::TestJoin through both CLIs, on seeded keys
    with repeats on both sides: the text parts byte-identical."""
    rng = np.random.default_rng(8)
    for side, n in (("L", 40), ("R", 30)):
        keys = rng.integers(0, 25, size=n)
        (tmp_path / f"{side}.txt").write_text("".join(
            f"k{int(k):02d}\t{side}|{side.lower()}{i}\n"
            for i, k in enumerate(keys)))
    extra = ["--outer"] if outer else []
    args = [f"file://{tmp_path}/L.txt", f"file://{tmp_path}/R.txt"]
    assert cli(["examples", "join"] + args + [f"file://{tmp_path}/out"]
               + extra + CPU + SPILLY) == 0
    assert jax_cli(["examples", "join"] + args + [f"file://{tmp_path}/jout"]
                   + extra) == 0
    got = text_parts(tmp_path / "out")
    assert got == text_parts(tmp_path / "jout")
    lines = got["part-00000"].decode().splitlines()
    assert lines and all(line.count("\t") == 2 for line in lines)


def test_examples_registry_lists_the_twelve_programs():
    """tpumr/examples/__init__.py's registry, whole: the twelve programs
    and sleep."""
    from tpumr.examples import programs as jax_programs
    from tpumr_torch.examples import programs
    assert sorted(programs()) == sorted(jax_programs())
    assert len(programs()) == 13


def _wordcount_conf(conf, pkg, root, out, compress):
    conf.set_input_paths(f"file://{root}/in")
    conf.set_output_path(f"file://{root}/{out}")
    conf.set("mapred.mapper.class", f"{pkg}.ops.wordcount.WordCountCpuMapper")
    conf.set("mapred.reducer.class", f"{pkg}.examples.basic.LongSumReducer")
    conf.set("mapred.combiner.class", f"{pkg}.examples.basic.LongSumReducer")
    conf.set_num_reduce_tasks(2)
    conf.set("io.sort.mb", 1)
    conf.set("io.sort.spill.percent", 0.002)
    if compress:
        conf.set("mapred.compress.map.output", True)
    return conf


def test_compressed_map_output_through_the_mini_cluster(tmp_path):
    """mapred.compress.map.output through the port's mini cluster: each
    map's zlib IFile served with its codec by get_map_output and decoded by
    the remote reduce, the part files the same as an uncompressed run's and
    the JAX package's mini cluster's; the same spill counters."""
    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(3)
    for m in range(3):
        words = rng.integers(0, 60, size=(60, 8))
        (tmp_path / "in" / f"f{m}.txt").write_text("".join(
            " ".join(f"w{int(x):02d}" for x in row) + "\n" for row in words))
    base = JobConf()
    base.set(DEVICE_KEY, "cpu")
    counters = {}
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0,
                       conf=base) as c:
        for out, compress in (("zlib", True), ("plain", False)):
            conf = _wordcount_conf(c.create_job_conf(), "tpumr_torch",
                                   tmp_path, out, compress)
            running = JobClient(conf).submit_job(conf)
            st = running.wait_for_completion(timeout=JOB_TIMEOUT)
            assert st["state"] == "SUCCEEDED", st
            counters[out] = running.counters()
    with JaxMiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0) as jc:
        jconf = _wordcount_conf(jc.create_job_conf(), "tpumr", tmp_path,
                                "jax", True)
        jst = JaxJobClient(jconf).submit_job(jconf).wait_for_completion(
            timeout=JOB_TIMEOUT)
    assert jst["state"] == "SUCCEEDED", jst
    got = text_parts(tmp_path / "zlib")
    assert got == text_parts(tmp_path / "plain") == text_parts(tmp_path / "jax")
    assert len(got) == 2
    for name in (TaskCounter.SPILLED_RECORDS,
                 TaskCounter.COMBINE_INPUT_RECORDS,
                 TaskCounter.MAP_OUTPUT_RECORDS):
        assert counters["zlib"].value(TaskCounter.FRAMEWORK_GROUP, name) == \
            counters["plain"].value(TaskCounter.FRAMEWORK_GROUP, name) > 0
    assert counters["zlib"].value(TaskCounter.FRAMEWORK_GROUP,
                                  TaskCounter.MAP_OUTPUT_RECORDS) == 3 * 60 * 8
