"""The port's new API (tpumr_torch.mapreduce: Context, Mapper, Reducer,
Partitioner, Job) and its library (tpumr_torch.mapreduce.lib: the
mappers, reducers and partitioners, JobControl, LazyOutputFormat) against
the JAX package's on the same inputs.

Each test names the test of tests/test_mapreduce_api.py or
tests/test_mapreduce_lib.py it mirrors, builds the same job in both
packages (the user classes subclass each package's own base classes) and
compares the part files byte for byte; the port runs with
tpumr_torch.device=cpu. The new-API kernel job (tests/test_mapreduce_api.
py:103-142) runs the port's plain version of the kernel on the CPU, JAX
its own on its CPU backend: the same ids from the two kernels' wrappers,
the same cluster counts, and centroids within tests/test_torch_job.py's
rtol 1e-5, atol 1e-6.
"""

import ast
import os
import threading
import zlib

import numpy as np
import pytest
import torch

import tpumr.mapreduce as jax_mr
import tpumr.mapreduce.lib as jax_mrlib
from tpumr.mapred import input_formats as jax_if
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.ops import kmeans as jax_km
from tpumr.ops.kmeans import clear_centroid_cache as jax_clear_centroids
from tpumr_torch import mapreduce as mr
from tpumr_torch.core.counters import BackendCounter, TaskCounter
from tpumr_torch.mapred import gpu_runner
from tpumr_torch.mapred import input_formats as port_if
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapreduce import lib as mrlib
from tpumr_torch.ops import kmeans as km

PKGS = {"jax": (jax_mr, jax_mrlib, jax_if, JaxJobConf),
        "port": (mr, mrlib, port_if, JobConf)}


def _classes(m):
    """The test's user classes over package ``m``'s new-API bases."""

    class TokenMapper(m.Mapper):
        def setup(self, context):
            self.setup_ran = True
            context.get_counter("app", "mapper_setups").increment()

        def map(self, key, value, context):
            assert self.setup_ran
            for w in value.split():
                context.write(w, 1)

        def cleanup(self, context):
            context.get_counter("app", "mapper_cleanups").increment()

    class SumReducer(m.Reducer):
        def setup(self, context):
            self.seen = 0

        def reduce(self, key, values, context):
            self.seen += 1
            context.write(key, sum(values))

        def cleanup(self, context):
            context.get_counter("app", "reducer_groups").increment(self.seen)

    class NumMapper(m.Mapper):
        def map(self, key, value, context):
            context.write(int(value), 1)

    class EvenOddPartitioner(m.Partitioner):
        def get_partition(self, key, value, num_partitions):
            return int(key) % num_partitions

    class CountCombiner(m.Reducer):
        def reduce(self, key, values, context):
            context.write(key, sum(values))

    class LifecycleReducer(m.Reducer):
        def setup(self, context):
            context.get_counter("app", "reduce_setups").increment()

        def cleanup(self, context):
            context.get_counter("app", "reduce_cleanups").increment()

    class FailingMapper(m.Mapper):
        def map(self, key, value, context):
            raise ValueError("intentional")

    class CentReducer(m.Reducer):
        """tests/test_mapreduce_api.py's CentReducer, with the count."""

        def reduce(self, key, values, context):
            total, n = None, 0
            for s, c in values:
                s = np.asarray(s, dtype=np.float64)
                total = s if total is None else total + s
                n += int(c)
            context.write(key, ((total / max(1, n)).tolist(), n))

    return {name: cls for name, cls in locals().items()
            if isinstance(cls, type)}


CLASSES = {pkg: _classes(v[0]) for pkg, v in PKGS.items()}


def _job(pkg, tmp_path, name, inp):
    m, _lib, _fmts, conf_cls = PKGS[pkg]
    conf = conf_cls()
    if pkg == "port":
        conf.set("tpumr_torch.device", "cpu")
    job = m.Job(conf, name=name)
    job.add_input_path(f"file://{inp}")
    job.set_output_path(f"file://{tmp_path}/{name}-{pkg}")
    return job


def _parts(tmp_path, name, pkg):
    out = tmp_path / f"{name}-{pkg}"
    return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))
            if f.startswith("part-")}


def _both(tmp_path, name, inp, setup):
    """``setup(job, classes, lib, fmts)`` in both packages; both jobs run
    and commit the same part files. The two jobs."""
    jobs = {}
    for pkg in ("jax", "port"):
        job = _job(pkg, tmp_path, name, inp)
        setup(job, CLASSES[pkg], PKGS[pkg][1], PKGS[pkg][2])
        assert job.wait_for_completion(), job.error
        jobs[pkg] = job
    assert _parts(tmp_path, name, "port") == _parts(tmp_path, name, "jax")
    return jobs


def _text(tmp_path, seed=1, lines=200, name="in.txt"):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 25, size=(lines, 4))
    path = tmp_path / name
    path.write_bytes(b"".join((" ".join(f"w{i}" for i in row) + "\n")
                              .encode() for row in ids))
    return path


# ------------------------------------------- tests/test_mapreduce_api.py


def test_wordcount_with_lifecycle(tmp_path):
    """TestNewApiWordCount::test_wordcount_with_lifecycle."""
    inp = _text(tmp_path)

    def setup(job, c, lib, fmts):
        job.set_input_format(fmts.TextInputFormat)
        job.set_mapper_class(c["TokenMapper"])
        job.set_reducer_class(c["SumReducer"])
        job.set_num_reduce_tasks(1)
    jobs = _both(tmp_path, "wc", inp, setup)
    assert jobs["port"].counters.to_dict()["app"] == \
        jobs["jax"].counters.to_dict()["app"]
    assert jobs["port"].counters.to_dict()["app"]["reducer_groups"] == 25


def test_identity_defaults(tmp_path):
    """TestNewApiWordCount::test_identity_defaults."""
    inp = _text(tmp_path, lines=20)

    def setup(job, c, lib, fmts):
        job.set_input_format(fmts.TextInputFormat)
        job.set_mapper_class(PKGS["port" if lib is mrlib else "jax"][0]
                             .Mapper)
        job.set_reducer_class(PKGS["port" if lib is mrlib else "jax"][0]
                              .Reducer)
    _both(tmp_path, "ident", inp, setup)


def test_custom_partitioner(tmp_path):
    """TestNewApiPartitioner::test_custom_partitioner."""
    (tmp_path / "n.txt").write_bytes(b"".join(b"%d\n" % i for i in range(30)))

    def setup(job, c, lib, fmts):
        job.set_input_format(fmts.TextInputFormat)
        job.set_mapper_class(c["NumMapper"])
        job.set_reducer_class(PKGS["port" if lib is mrlib else "jax"][0]
                              .Reducer)
        job.set_partitioner_class(c["EvenOddPartitioner"])
        job.set_num_reduce_tasks(2)
    _both(tmp_path, "parts", tmp_path / "n.txt", setup)
    part0 = (tmp_path / "parts-port" / "part-00000").read_text()
    assert all(int(l.split("\t")[0]) % 2 == 0 for l in part0.splitlines())


def test_combiner_applied(tmp_path):
    """TestNewApiCombiner::test_combiner_applied."""
    (tmp_path / "q.txt").write_bytes(b"q q q q\n" * 50)

    def setup(job, c, lib, fmts):
        job.set_input_format(fmts.TextInputFormat)
        job.set_mapper_class(c["TokenMapper"])
        job.set_combiner_class(c["CountCombiner"])
        job.set_reducer_class(c["SumReducer"])
        job.conf.set("io.sort.mb", 1)
    jobs = _both(tmp_path, "comb", tmp_path / "q.txt", setup)
    assert (tmp_path / "comb-port" / "part-00000").read_bytes() == b"q\t200\n"
    group = TaskCounter.FRAMEWORK_GROUP
    assert jobs["port"].counters.value(
        group, TaskCounter.COMBINE_INPUT_RECORDS) == 200


def test_empty_partition_still_runs_lifecycle(tmp_path):
    """TestNewApiCombiner::test_empty_partition_still_runs_lifecycle."""
    (tmp_path / "s.txt").write_bytes(b"same same\n")

    def setup(job, c, lib, fmts):
        job.set_input_format(fmts.TextInputFormat)
        job.set_mapper_class(c["TokenMapper"])
        job.set_reducer_class(c["LifecycleReducer"])
        job.set_num_reduce_tasks(2)
    jobs = _both(tmp_path, "empty", tmp_path / "s.txt", setup)
    app = jobs["port"].counters.to_dict()["app"]
    assert app["reduce_setups"] == app["reduce_cleanups"] == 2


def test_wait_for_completion_returns_false_on_failure(tmp_path):
    """TestNewApiCombiner::test_wait_for_completion_returns_false_on_failure:
    False, no exception, the error on job.error."""
    (tmp_path / "b.txt").write_bytes(b"boom\n")
    job = _job("port", tmp_path, "fails", tmp_path / "b.txt")
    job.set_mapper_class(CLASSES["port"]["FailingMapper"])
    assert job.wait_for_completion() is False
    assert "intentional" in job.error
    assert job.counters is None


def test_kernel_job_through_new_api(tmp_path):
    """TestNewApiTpuKernel::test_kernel_job_through_new_api at
    tests/test_mapreduce_api.py:103-142's shapes (100 x 4 points, k = 3,
    splits of 50), set_map_kernel("kmeans-assign") on the device path
    (tpumr.local.run.on.tpu), through both packages."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(100, 4)).astype(np.float32)
    np.save(tmp_path / "points.npy", pts)
    np.save(tmp_path / "cents.npy", pts[:3])
    got = {}
    for pkg in ("jax", "port"):
        jax_clear_centroids()
        km.clear_centroid_cache()
        gpu_runner.clear_split_caches()
        job = _job(pkg, tmp_path, "kmeans", tmp_path / "points.npy")
        job.set_input_format(PKGS[pkg][2].DenseInputFormat)
        job.conf.set("tpumr.dense.split.rows", 50)
        job.conf.set("tpumr.kmeans.centroids", f"file://{tmp_path}/cents.npy")
        job.set_map_kernel("kmeans-assign")
        job.set_reducer_class(CLASSES[pkg]["CentReducer"])
        job.conf.set("tpumr.local.run.on.tpu", True)
        assert job.wait_for_completion(), job.error
        got[pkg] = job
    assert got["port"].counters.value(BackendCounter.GROUP,
                                      BackendCounter.TPU_MAP_TASKS) == 2
    cents = {}
    for pkg in ("jax", "port"):
        text = (tmp_path / f"kmeans-{pkg}" / "part-00000").read_text()
        cents[pkg] = {int(k): ast.literal_eval(v) for k, v in
                      (l.split("\t") for l in text.splitlines())}
    assert sorted(cents["port"]) == sorted(cents["jax"]) == [0, 1, 2]
    for cid in cents["jax"]:
        (mp, np_), (mj, nj) = cents["port"][cid], cents["jax"][cid]
        assert np_ == nj
        np.testing.assert_allclose(mp, mj, rtol=1e-5, atol=1e-6)
    # the ids of the two kernels' wrappers on the job's points
    ids_port = km.assign_and_partials(torch.from_numpy(pts),
                                      torch.from_numpy(pts[:3]))[0]
    ids_jax = jax_km.assign_and_partials(pts, pts[:3], use_pallas=True,
                                         interpret=True)[0]
    assert ids_port.numpy().tolist() == np.asarray(ids_jax).tolist()


# ------------------------------------------- tests/test_mapreduce_lib.py


def test_wordcount_through_new_api_lib(tmp_path):
    """TestLibEndToEnd::test_wordcount_through_new_api."""
    inp = _text(tmp_path, seed=3)

    def setup(job, c, lib, fmts):
        job.set_mapper_class(lib.TokenCounterMapper)
        job.set_combiner_class(lib.IntSumReducer)
        job.set_reducer_class(lib.IntSumReducer)
        job.set_num_reduce_tasks(1)
    _both(tmp_path, "wclib", inp, setup)


@pytest.mark.parametrize("keys", [("mapreduce.mapper.regex",
                                   "mapreduce.mapper.regex.group"),
                                  ("mapred.mapper.regex",
                                   "mapred.mapper.regex.group")])
def test_grep_through_new_api(tmp_path, keys):
    """TestLibEndToEnd::test_grep_through_new_api, under the new and the
    old key names."""
    (tmp_path / "g.txt").write_bytes(b"error: one\nok\nerror: two\n" * 5)

    def setup(job, c, lib, fmts):
        job.conf.set(keys[0], r"error: (\w+)")
        job.conf.set(keys[1], 1)
        job.set_mapper_class(lib.RegexMapper)
        job.set_reducer_class(lib.LongSumReducer)
    _both(tmp_path, "grep", tmp_path / "g.txt", setup)
    assert (tmp_path / "grep-port" / "part-00000").read_bytes() == \
        b"one\t5\ntwo\t5\n"


def test_inverse_mapper(tmp_path):
    """TestLibEndToEnd::test_inverse_mapper."""
    (tmp_path / "i.txt").write_bytes(b"x\ny\n")

    def setup(job, c, lib, fmts):
        job.set_mapper_class(lib.InverseMapper)
        job.set_num_reduce_tasks(0)
    _both(tmp_path, "inv", tmp_path / "i.txt", setup)
    assert (tmp_path / "inv-port" / "part-00000").read_bytes() == \
        b"x\t0\ny\t2\n"


def test_multithreaded_mapper(tmp_path):
    """TestLibEndToEnd::test_multithreaded_mapper: one inner mapper for
    every thread, every record once."""
    (tmp_path / "mt.txt").write_bytes(b"".join(b"w%d\n" % i
                                               for i in range(200)))

    def setup(job, c, lib, fmts):
        job.conf.set_class("mapreduce.mapper.multithreadedmapper.class",
                           lib.TokenCounterMapper)
        job.conf.set("mapreduce.mapper.multithreadedmapper.threads", 4)
        job.set_mapper_class(lib.MultithreadedMapper)
        job.set_reducer_class(lib.IntSumReducer)
    _both(tmp_path, "mt", tmp_path / "mt.txt", setup)
    assert (tmp_path / "mt-port" / "part-00000").read_text() \
        .count("\t1\n") == 200


def test_multithreaded_mapper_propagates_error(tmp_path):
    """TestLibEndToEnd::test_multithreaded_mapper_propagates_error."""

    class Boom(mr.Mapper):
        def map(self, key, value, context):
            raise ValueError("inner mapper failure")

    (tmp_path / "e.txt").write_bytes(b"a\nb\n")
    job = _job("port", tmp_path, "mte", tmp_path / "e.txt")
    job.conf.set_class("mapreduce.mapper.multithreadedmapper.class", Boom)
    job.set_mapper_class(mrlib.MultithreadedMapper)
    before = threading.active_count()
    assert not job.wait_for_completion()
    assert "inner mapper failure" in job.error
    assert threading.active_count() == before


def test_multithreaded_mapper_serialises_writes_under_stress():
    """MultithreadedMapper's writes reach a collector that is not
    thread-safe one at a time: 32 threads, a 1 µs switch interval, and a
    check-then-act collector that would lose records if two writes
    overlapped."""
    import sys
    conf = JobConf()
    conf.set_class("mapreduce.mapper.multithreadedmapper.class",
                   mrlib.TokenCounterMapper)
    conf.set("mapreduce.mapper.multithreadedmapper.threads", 32)
    slots, n = [None] * 20_000, [0]

    def collect(k, v):
        i = n[0]
        slots[i] = k
        n[0] = i + 1

    from tpumr_torch.mapred.api import OutputCollector, Reporter
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mrlib.MultithreadedMapper().run(
            ((i, f"w{i}") for i in range(20_000)),
            mr.Context(conf, OutputCollector(collect), Reporter()))
    finally:
        sys.setswitchinterval(old)
    assert n[0] == 20_000
    assert sorted(slots) == sorted(f"w{i}" for i in range(20_000))


def test_binary_partitioner_ranges():
    """TestPartitioners::test_binary_partitioner_ranges: the JAX package's
    partitions."""
    keys = [b"aa-111", b"aa-222", b"zz", "text-key", b""]
    for lr in ((0, -1), (0, 1), (-3, -1), (2, 3)):
        p, q = mrlib.BinaryPartitioner(*lr), jax_mrlib.BinaryPartitioner(*lr)
        assert [p.get_partition(k, None, 16) for k in keys] == \
            [q.get_partition(k, None, 16) for k in keys]
    assert mrlib.BinaryPartitioner(0, 1).get_partition(b"aa-1", None, 16) \
        == zlib.crc32(b"aa") % 16


def test_key_field_and_hash_partitioners_delegate():
    """TestPartitioners::test_key_field_partitioner_delegates, and the
    hash partitioner's keys as the JAX package places them."""
    keys = [f"k{i % 7}\tx{i}" for i in range(50)]
    p, q = mrlib.KeyFieldBasedPartitioner(1), \
        jax_mrlib.KeyFieldBasedPartitioner(1)
    assert [p.get_partition(k, None, 8) for k in keys] == \
        [q.get_partition(k, None, 8) for k in keys]
    h, g = mrlib.HashPartitioner(), jax_mrlib.HashPartitioner()
    assert [h.get_partition(k, None, 8) for k in keys] == \
        [g.get_partition(k, None, 8) for k in keys]


def test_partitioner_wired_through_job(tmp_path):
    """TestPartitioners::test_partitioner_wired_through_job."""
    (tmp_path / "p.txt").write_bytes(b"a 1\na 2\nb 3\n")

    def setup(job, c, lib, fmts):
        job.set_mapper_class(lib.TokenCounterMapper)
        job.set_reducer_class(lib.IntSumReducer)
        job.set_partitioner_class(lib.BinaryPartitioner)
        job.set_num_reduce_tasks(2)
    _both(tmp_path, "bpart", tmp_path / "p.txt", setup)


def test_total_order_partitioner_new_api_face(tmp_path):
    """The new-API TotalOrderPartitioner over the engine's partition file:
    the same partition of every key as the JAX package's, and unconfigured
    it raises."""
    from tpumr.mapred import total_order as jax_to
    from tpumr_torch.mapred import total_order as to
    samples = [f"k{i:03d}" for i in range(0, 100, 7)]
    got = {}
    for pkg, (mod, lib) in {"jax": (jax_to, jax_mrlib),
                            "port": (to, mrlib)}.items():
        conf = PKGS[pkg][3]()
        path = f"file://{tmp_path}/{pkg}.partitions"
        mod.write_partition_file(conf, path, samples, 4)
        conf.set("total.order.partitioner.path", path)
        p = lib.TotalOrderPartitioner()
        p.configure(conf)
        got[pkg] = [p.get_partition(f"k{i:03d}", None, 4) for i in range(100)]
    assert got["port"] == got["jax"]
    assert got["port"] == sorted(got["port"]) and got["port"][-1] == 3
    with pytest.raises(RuntimeError, match="not configured"):
        mrlib.TotalOrderPartitioner().get_partition("k", None, 4)


def test_lazy_output_writes_no_empty_part(tmp_path):
    """TestLazyOutput::test_empty_partition_writes_no_part_file."""
    (tmp_path / "lz.txt").write_bytes(b"only one key\n")

    def setup(job, c, lib, fmts):
        job.set_mapper_class(lib.TokenCounterMapper)
        job.set_reducer_class(lib.IntSumReducer)
        lib.LazyOutputFormat.set_output_format_class(job, lib.TextOutputFormat)
        job.set_num_reduce_tasks(4)
    _both(tmp_path, "lazy", tmp_path / "lz.txt", setup)
    assert 0 < len(_parts(tmp_path, "lazy", "port")) < 4


def _jc_job(pkg, tmp_path, name, inp):
    job = _job(pkg, tmp_path, name, inp)
    job.set_mapper_class(PKGS[pkg][1].TokenCounterMapper)
    job.set_reducer_class(PKGS[pkg][1].IntSumReducer)
    return job


def test_job_control_dependency_order_and_success(tmp_path):
    """TestJobControl::test_dependency_order_and_success: the second job
    reads the first's output; both packages commit the same parts."""
    inp = _text(tmp_path, seed=4, lines=30)
    for pkg in ("jax", "port"):
        lib = PKGS[pkg][1]
        j1 = _jc_job(pkg, tmp_path, "first", inp)
        j2 = _jc_job(pkg, tmp_path, "second", tmp_path / f"first-{pkg}")
        jc = lib.JobControl()
        c1 = jc.add_job(lib.ControlledJob(j1))
        c2 = jc.add_job(lib.ControlledJob(j2, depending=[c1]))
        jc.run()
        assert jc.all_finished and not jc.failed_jobs()
        assert (c1.state, c2.state) == ("SUCCESS", "SUCCESS")
        assert jc.successful_jobs() == [c1, c2]
    for name in ("first", "second"):
        assert _parts(tmp_path, name, "port") == _parts(tmp_path, name, "jax")


def test_job_control_dependent_failure_propagates(tmp_path):
    """TestJobControl::test_dependent_failure_propagates."""
    lib = mrlib
    j1 = _jc_job("port", tmp_path, "bad", tmp_path / "missing")
    j2 = _jc_job("port", tmp_path, "after", tmp_path / "bad-port")
    jc = lib.JobControl()
    c1 = jc.add_job(lib.ControlledJob(j1))
    c2 = jc.add_job(lib.ControlledJob(j2, depending=[c1]))
    jc.run()
    assert c1.state == lib.ControlledJob.FAILED and c1.message
    assert c2.state == lib.ControlledJob.DEPENDENT_FAILED
    assert jc.failed_jobs() == [c1, c2]


def test_job_control_on_a_thread_ends_and_stops(tmp_path):
    """JobControl in a thread of its own, the way the reference drives
    it: the thread ends once every job settled; a stopped JobControl
    starts no further job and its thread ends too."""
    inp = _text(tmp_path, seed=5, lines=10)
    jc = mrlib.JobControl()
    c1 = jc.add_job(mrlib.ControlledJob(_jc_job("port", tmp_path, "t1", inp)))
    c2 = jc.add_job(mrlib.ControlledJob(
        _jc_job("port", tmp_path, "t2", tmp_path / "t1-port"), [c1]))
    t = threading.Thread(target=jc.run, daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive() and jc.all_finished
    assert (c1.state, c2.state) == ("SUCCESS", "SUCCESS")

    never = mrlib.ControlledJob(_jc_job("port", tmp_path, "t3", inp),
                                depending=[mrlib.ControlledJob(
                                    _jc_job("port", tmp_path, "t4", inp))])
    jc2 = mrlib.JobControl()
    jc2.add_job(never)   # its dependency is in no JobControl: it waits
    t = threading.Thread(target=jc2.run, daemon=True)
    t.start()
    jc2.stop()
    t.join(10)
    assert not t.is_alive() and never.state == mrlib.ControlledJob.WAITING
