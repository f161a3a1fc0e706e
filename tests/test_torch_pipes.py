"""The port's pipes tier against the JAX package's, case by case.

Oracles: tests/test_pipes.py (test_varint_roundtrip,
test_pipes_wordcount_python_child, test_pipes_dual_executable_tpu_selection,
test_pipes_distributed_hybrid, test_pipes_wordcount_cpp_child,
test_pipes_wordcount_part_cpp_partitioner, test_pipes_sort_cpp_identity,
test_pipes_wordcount_nopipe_child_reads_split and
test_pipes_nopipe_python_child), each job also run through the JAX
package on the same input, whose records the port's must equal (the
Python children of both runs use the port's runtime, which starts in
milliseconds; the JAX package's runtime is driven by the cross tests). The
frames of both packages' protocols are compared byte for byte, and each
package's framework drives a child written against the other's runtime.
The accelerator runner's choice (``mapred.map.runner.tpu.class``) and the
gate that lets a job naming only a pipes GPU executable onto accelerator
slots are held against the JAX package's. Every child is reaped, every
socket and child wait is bounded, and the cluster stops its threads.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import pytest

from tpumr.mapred.ids import JobID as JaxJobID
from tpumr.mapred.job_in_progress import JobInProgress as JaxJobInProgress
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.pipes import Submitter as JaxSubmitter
from tpumr.pipes import protocol as JP
from tpumr_torch.core.counters import BackendCounter
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.mapred import local_runner
from tpumr_torch.mapred.gpu_runner import GpuMapRunner, prelaunch_device_maps
from tpumr_torch.mapred.ids import JobID, TaskAttemptID, TaskID
from tpumr_torch.mapred.job_client import JobClient
from tpumr_torch.mapred.job_in_progress import JobInProgress
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.mapred.task import Task
from tpumr_torch.pipes import PipesGPUMapRunner, Submitter
from tpumr_torch.pipes import protocol as P
from tpumr_torch.pipes.submitter import setup_pipes_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a cluster job may take here
JOB_TIMEOUT = 60


def _write_script(path, body: str) -> str:
    with open(path, "w") as f:
        f.write(f"#!{sys.executable}\nimport sys\n"
                f"sys.path.insert(0, {REPO!r})\n" + textwrap.dedent(body))
    os.chmod(path, 0o755)
    return str(path)


#: tests/test_pipes.py's WORDCOUNT, with the runtime's package a parameter
WORDCOUNT = """
    from {pkg}.pipes import child

    class M(child.Mapper):
        def __init__(self, ctx):
            self.words = ctx.get_counter("WordCount", "INPUT_WORDS")

        def map(self, ctx):
            toks = ctx.input_value.split()
            for w in toks:
                ctx.emit(w, b"1")
            ctx.increment_counter(self.words, len(toks))

    class R(child.Reducer):
        def reduce(self, ctx):
            total = 0
            while ctx.next_value():
                total += int(ctx.input_value)
            ctx.emit(ctx.input_key, str(total))

    class F(child.Factory):
        def create_mapper(self, ctx):
            return M(ctx)

        def create_reducer(self, ctx):
            return R()

    raise SystemExit(child.run_task(F()))
"""

#: tests/test_pipes.py's DEVICE_PROBE: argv[1] comes back as the value
DEVICE_PROBE = """
    from {pkg}.pipes import child

    device = sys.argv[1] if len(sys.argv) > 1 else "none"

    class M(child.Mapper):
        def map(self, ctx):
            ctx.emit(ctx.input_value, "dev=" + device)

    class R(child.Reducer):
        def reduce(self, ctx):
            while ctx.next_value():
                ctx.emit(ctx.input_key, ctx.input_value)

    class F(child.Factory):
        def create_mapper(self, ctx):
            return M()

        def create_reducer(self, ctx):
            return R()

    raise SystemExit(child.run_task(F()))
"""

#: tests/test_pipes.py's NOPIPE_PY: the child reads its split itself
NOPIPE = """
    import json
    from {pkg}.pipes import child

    class M(child.Mapper):
        def map(self, ctx):
            split = json.loads(ctx.input_split.decode())
            path = split["path"].replace("file://", "")
            start, length = split["start"], split["split_length"]
            with open(path, "rb") as f:
                if start > 0:
                    f.seek(start - 1)
                    f.readline()
                while f.tell() < start + length:
                    line = f.readline()
                    if not line:
                        break
                    for w in line.split():
                        ctx.emit(w, "1")

    class R(child.Reducer):
        def reduce(self, ctx):
            total = 0
            while ctx.next_value():
                total += int(ctx.input_value)
            ctx.emit(ctx.input_key, str(total))

    class F(child.Factory):
        def create_mapper(self, ctx):
            return M()

        def create_reducer(self, ctx):
            return R()

    raise SystemExit(child.run_task(F()))
"""


def _script(tmp_path, name: str, body: str, pkg: str) -> str:
    return _write_script(tmp_path / f"{name}-{pkg}.py", body.format(pkg=pkg))


def _conf(pkg: str, tmp_path, src, tag: str, reduces: int = 1, **keys):
    """A pipes job's conf for either package over the file ``src``."""
    conf = JobConf() if pkg == "port" else JaxJobConf()
    if pkg == "port":
        conf.set(DEVICE_KEY, "cpu")
    conf.set_input_paths(f"file://{src}")
    conf.set_output_path(f"file://{tmp_path}/{tag}-{pkg}")
    conf.set_num_reduce_tasks(reduces)
    conf.set("tpumr.cache.dir", str(tmp_path / f"cache-{pkg}"))
    for k, v in keys.items():
        conf.set(k.replace("_", "."), v)
    return conf


def _parts(out_dir) -> "dict[str, list[str]]":
    """part file name -> its lines."""
    return {name: (out_dir / name).read_text().splitlines()
            for name in sorted(os.listdir(out_dir))
            if name.startswith("part-")}


def _counts(parts: dict) -> dict:
    return dict(line.split("\t") for lines in parts.values()
                for line in lines)


def _run_both(tmp_path, src, tag, cpu_bin: dict, tpu_bin=None,
              reduces: int = 1, **keys):
    """The job through each package's Submitter: (port result, its parts,
    the JAX package's parts), the parts equal."""
    results, parts = {}, {}
    for pkg, submitter in (("port", Submitter), ("jax", JaxSubmitter)):
        conf = _conf(pkg, tmp_path, src, tag, reduces, **keys)
        submitter.set_executable(conf, cpu_bin[pkg])
        if tpu_bin is not None:
            submitter.set_tpu_executable(conf, tpu_bin[pkg])
        results[pkg] = submitter.run_job(conf)
        assert results[pkg].successful
        parts[pkg] = _parts(tmp_path / f"{tag}-{pkg}")
    assert parts["port"] == parts["jax"]
    return results["port"], parts["port"]


# ------------------------------------------------------------ the protocol


def test_varint_roundtrip():
    """test_varint_roundtrip, across the packages: each decodes the
    other's vints, and the bytes are the same."""
    values = (0, 1, 127, 128, 300, 2**21, 2**40)
    mine, theirs = io.BytesIO(), io.BytesIO()
    for n in values:
        P.write_varint(mine, n)
        JP.write_varint(theirs, n)
    assert mine.getvalue() == theirs.getvalue()
    mine.seek(0)
    theirs.seek(0)
    assert [JP.read_varint(mine) for _ in values] == list(values)
    assert [P.read_varint(theirs) for _ in values] == list(values)


def test_downward_frames_are_the_jax_packages_byte_for_byte():
    """Every downward message of both packages' DownwardProtocol, and the
    digest, give the same bytes."""
    out = {}
    for name, mod in (("port", P), ("jax", JP)):
        buf = io.BytesIO()
        d = mod.DownwardProtocol(buf)
        d.authenticate(mod.create_digest(b"k" * 16, b"CLIENT-AUTH"),
                       b"challenge")
        d.start()
        d.set_job_conf({"a": "1", "b": 2, "c": None, "é": "ü"})
        d.set_input_types("K", "V")
        d.run_map(b'{"path": "x"}', 3, piped_input=False)
        d.map_item(b"k\x00", "vé".encode())
        d.run_reduce(7, piped_output=True)
        d.reduce_key(b"key")
        d.reduce_value(b"")
        d.close()
        d.abort()
        mod.write_str(buf, "status ü")
        mod.write_double(buf, -2.5e-300)
        out[name] = buf.getvalue()
    assert out["port"] == out["jax"]


# ------------------------------------------------------------ Python children


def test_pipes_wordcount_python_child(tmp_path):
    """test_pipes_wordcount_python_child: the counts and the child's
    counter (REGISTER/INCREMENT_COUNTER) in both packages."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"a b a\nc b a\n" * 30)
    prog = _script(tmp_path, "wc", WORDCOUNT, "tpumr_torch")
    result, parts = _run_both(tmp_path, src, "wc",
                              {"port": prog, "jax": prog})
    assert _counts(parts) == {"a": "90", "b": "60", "c": "30"}
    assert result.counters.value("WordCount", "INPUT_WORDS") == 180


@pytest.mark.parametrize("framework", ["port", "jax"])
def test_frames_cross_the_packages(tmp_path, framework):
    """Each package's framework drives a child written against the other
    package's runtime, and gets the records the same-package pair gets:
    the frames are the same both ways."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"x y x\nz\n" * 7)
    runtime = {"port": "tpumr", "jax": "tpumr_torch"}[framework]
    same = {"port": "tpumr_torch", "jax": "tpumr"}[framework]
    submitter = Submitter if framework == "port" else JaxSubmitter
    got = {}
    for tag, pkg in (("cross", runtime), ("same", same)):
        conf = _conf(framework, tmp_path, src, tag)
        submitter.set_executable(conf, _script(tmp_path, f"wc-{tag}",
                                               WORDCOUNT, pkg))
        result = submitter.run_job(conf)
        assert result.successful
        assert result.counters.value("WordCount", "INPUT_WORDS") == 28
        got[tag] = _parts(tmp_path / f"{tag}-{framework}")
    assert got["cross"] == got["same"]
    assert _counts(got["cross"]) == {"x": "14", "y": "7", "z": "7"}


def test_pipes_dual_executable_tpu_selection(tmp_path):
    """test_pipes_dual_executable_tpu_selection: a job naming a pipes GPU
    executable and ``tpumr.local.run.on.tpu`` runs its maps through
    PipesGPUMapRunner, the second cached binary, with the CUDA ordinal as
    argv[1]: on the CPU the slot's device id, 0, the records the JAX
    package's test expects of it (its run here would start a JAX device
    runtime for nothing else)."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"r1\nr2\n")
    conf = _conf("port", tmp_path, src, "dual", tpumr_local_run_on_tpu=True)
    Submitter.set_executable(conf, _script(tmp_path, "cpu", DEVICE_PROBE,
                                           "tpumr_torch"))
    Submitter.set_tpu_executable(conf, _script(tmp_path, "tpu", DEVICE_PROBE,
                                               "tpumr_torch"))
    result = Submitter.run_job(conf)
    assert result.successful
    assert _counts(_parts(tmp_path / "dual-port")) == \
        {"r1": "dev=0", "r2": "dev=0"}
    assert result.counters.value(BackendCounter.GROUP,
                                 BackendCounter.TPU_MAP_TASKS) == 1
    assert conf.get_tpu_map_runner_class() is PipesGPUMapRunner


def test_pipes_nopipe_python_child(tmp_path):
    """test_pipes_nopipe_python_child: with piped input off the child maps
    once over the split it reads itself."""
    src = tmp_path / "np-in.txt"
    src.write_bytes(b"dog cat dog\ncat\n" * 30)
    prog = _script(tmp_path, "nopipe", NOPIPE, "tpumr_torch")
    _result, parts = _run_both(tmp_path, src, "np",
                               {"port": prog, "jax": prog},
                               mapred_map_tasks=2, mapred_min_split_size=1,
                               tpumr_pipes_piped_input=False)
    assert {k: int(v) for k, v in _counts(parts).items()} == \
        {"dog": 60, "cat": 60}


# ------------------------------------------------------------ runner choice


class _TaggingRunner:
    """An accelerator runner of the test's own: one record per map."""

    def configure(self, conf):
        self.conf = conf

    def run(self, reader, output, reporter, task_ctx=None):
        output.collect("runner", "custom")


def test_tpu_map_runner_class_is_honoured(tmp_path):
    """``mapred.map.runner.tpu.class`` picks an accelerator task's runner
    (tpumr/mapred/map_task.py:248-249), where the port hard-coded
    GpuMapRunner; and the window does not take a job whose accelerator
    runner is not GpuMapRunner's."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"a\nb\nc\n")
    parts = {}
    for pkg in ("port", "jax"):
        conf = _conf(pkg, tmp_path, src, "runner", mapred_map_tasks=3,
                     mapred_min_split_size=1, tpumr_local_run_on_tpu=True)
        conf.set_map_kernel("wordcount")
        conf.set_tpu_map_runner_class(_TaggingRunner)
        if pkg == "port":
            assert conf.get_tpu_map_runner_class() is _TaggingRunner
            assert prelaunch_device_maps(conf, []) is None
            assert local_runner.run_job(conf).successful
        else:
            from tpumr.mapred.job_client import JobClient as JaxClient
            assert JaxClient(conf).run_job(conf).successful
        parts[pkg] = _parts(tmp_path / f"runner-{pkg}")
    assert parts["port"] == parts["jax"]
    assert _counts(parts["port"]) == {"runner": "custom"}
    assert JobConf().get_tpu_map_runner_class() is GpuMapRunner


def test_gate_admits_a_pipes_gpu_executable_alone():
    """The accelerator gate of the scheduler and of the local runner
    (tpumr/mapred/job_in_progress.py:441-451, local_runner.py:79-81): a job
    with ``tpumr.pipes.tpu.executable`` and no kernel takes accelerator
    slots, as in the JAX package; the window declines it without
    raising."""
    import torch
    for key, want in (("tpumr.pipes.tpu.executable", True),
                      ("tpumr.pipes.executable", False)):
        conf_dict = {key: "/bin/true"}
        assert JobInProgress(JobID("j", 1), conf_dict, []).has_kernel() \
            is want
        assert JaxJobInProgress(JaxJobID("j", 1), conf_dict, []) \
            .has_kernel() is want
        conf = JobConf()
        conf.set(key, "/bin/true")
        conf.set("tpumr.local.run.on.tpu", True)
        assert local_runner.maps_on_device(conf, torch.device("cpu")) is want
    conf = JobConf()
    conf.set("tpumr.pipes.tpu.executable", "/bin/true")
    setup_conf = JobConf(conf)
    setup_conf.set("tpumr.pipes.executable", "/bin/true")
    setup_pipes_job(setup_conf)
    assert setup_conf.get_tpu_map_runner_class() is PipesGPUMapRunner
    task = Task(TaskAttemptID(TaskID(JobID("j", 1), True, 0), 0),
                partition=0, split={"type": "x"}, run_on_tpu=True,
                tpu_device_id=0)
    assert prelaunch_device_maps(setup_conf, [task]) is None


def test_pipes_distributed_hybrid(tmp_path):
    """test_pipes_distributed_hybrid on the port's mini cluster: the pipes
    GPU executable alone lets the job onto the GPU slot, whose attempts
    run the second binary with the device id as argv[1]."""
    cpu = _script(tmp_path, "cpu", DEVICE_PROBE, "tpumr_torch")
    tpu = _script(tmp_path, "tpu", DEVICE_PROBE, "tpumr_torch")
    src = tmp_path / "in.txt"
    src.write_bytes("".join(f"rec{i:03d}\n" for i in range(12)).encode())
    base = JobConf()
    base.set(DEVICE_KEY, "cpu")
    with MiniMRCluster(num_trackers=1, cpu_slots=1, tpu_slots=1,
                       conf=base) as cluster:
        conf = cluster.create_job_conf()
        conf.set_input_paths(f"file://{src}")
        conf.set_output_path(f"file://{tmp_path}/dh")
        conf.set_num_reduce_tasks(1)
        conf.set("mapred.map.tasks", 6)
        conf.set("mapred.min.split.size", 1)
        Submitter.set_executable(conf, cpu)
        Submitter.set_tpu_executable(conf, tpu)
        setup_pipes_job(conf)
        client = JobClient(conf)
        try:
            running = client.submit_job(conf)
            st = running.wait_for_completion(timeout=JOB_TIMEOUT)
            reports = running.task_reports("map")
        finally:
            client.close()
    assert st["state"] == "SUCCEEDED", st
    assert st["finished_tpu_maps"] > 0, st
    out = _counts(_parts(tmp_path / "dh"))
    assert sorted(out) == [f"rec{i:03d}" for i in range(12)]
    assert set(out.values()) == {"dev=0", "dev=none"}
    assert sum(r["run_on_tpu"] for r in reports) == st["finished_tpu_maps"]
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith(("heartbeat-", "task-", "pipes-"))]


# ------------------------------------------------------------ C++ children


@pytest.fixture(scope="module", autouse=True)
def _cpp_build(tmp_path_factory):
    """native/pipes' four examples, built into a directory of the test's
    own (native/ is left as it is) by a ``make`` started at the file's
    first test, so that the build runs beside the tests before the C++
    ones; reaped at the end of the file."""
    if shutil.which("g++") is None:
        yield None
        return
    build = tmp_path_factory.mktemp("pipes-build")
    proc = subprocess.Popen(["make", "-C", os.path.join(REPO, "native",
                                                        "pipes"),
                             f"BUILD={build}"], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield build, proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=60)


@pytest.fixture
def cpp_examples(_cpp_build):
    """The built examples' directory, once ``make`` has ended."""
    if _cpp_build is None:
        pytest.skip("g++ not available")
    build, proc = _cpp_build
    try:
        _out, err = proc.communicate(timeout=120)
    except ValueError:   # read already: the build ended for an earlier test
        err = ""
    if proc.returncode != 0:
        pytest.fail(f"native pipes build failed:\n{err}")
    return build


def _cpp(cpp_examples, name: str) -> dict:
    path = str(cpp_examples / name)
    return {"port": path, "jax": path}


def test_pipes_wordcount_cpp_child(cpp_examples, tmp_path):
    """test_pipes_wordcount_cpp_child."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"tpu mxu tpu\nici mxu tpu\n" * 10)
    result, parts = _run_both(tmp_path, src, "cppwc",
                              _cpp(cpp_examples, "wordcount"))
    assert _counts(parts) == {"tpu": "30", "mxu": "20", "ici": "10"}
    assert result.counters.value("WordCount", "INPUT_WORDS") == 60


def test_pipes_wordcount_part_cpp_partitioner(cpp_examples, tmp_path):
    """test_pipes_wordcount_part_cpp_partitioner: the child's partition
    (PARTITIONED_OUTPUT) decides the part."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"apple crumble apple\nbanana crumble\n" * 5)
    _result, parts = _run_both(tmp_path, src, "cpppart",
                               _cpp(cpp_examples, "wordcount-part"),
                               reduces=2)
    assert _counts(parts) == {"apple": "10", "banana": "5", "crumble": "10"}
    for name, lines in parts.items():
        for line in lines:
            assert int(name.rsplit("-", 1)[1]) == ord(line[0]) % 2


def test_pipes_sort_cpp_identity(cpp_examples, tmp_path):
    """test_pipes_sort_cpp_identity."""
    lines = [f"k{97 - i:03d}" for i in range(60)]
    src = tmp_path / "in.txt"
    src.write_bytes(("\n".join(lines) + "\n").encode())
    _result, parts = _run_both(tmp_path, src, "cppsort",
                               _cpp(cpp_examples, "sort"))
    assert [ln.split("\t")[0] for ln in parts["part-00000"]] == sorted(lines)


def test_pipes_wordcount_nopipe_child_reads_split(cpp_examples, tmp_path):
    """test_pipes_wordcount_nopipe_child_reads_split: the child parses the
    split's JSON and reads its own byte range, no line counted twice."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"red green red\nblue green\n" * 40)
    _result, parts = _run_both(tmp_path, src, "cppnp",
                               _cpp(cpp_examples, "wordcount-nopipe"),
                               mapred_map_tasks=3, mapred_min_split_size=1,
                               tpumr_pipes_piped_input=False)
    assert {k: int(v) for k, v in _counts(parts).items()} == \
        {"red": 80, "green": 80, "blue": 40}


def test_pipes_command_runs_a_job(cpp_examples, tmp_path):
    """``tpumr_torch.cli pipes`` with the JAX package's flags
    (tpumr/pipes/submitter.py:83-110)."""
    from tpumr_torch import cli
    src = tmp_path / "in.txt"
    src.write_bytes(b"tpu mxu tpu\n")
    assert cli.main(["-D", f"{DEVICE_KEY}=cpu", "pipes", "-program",
                     str(cpp_examples / "wordcount"),
                     "-input", f"file://{src}", "-output",
                     f"file://{tmp_path}/cli", "-reduces", "1", "-jobconf",
                     f"tpumr.cache.dir={tmp_path}/cache-cli"]) == 0
    assert _counts(_parts(tmp_path / "cli")) == {"tpu": "2", "mxu": "1"}


def test_split_json_names_the_byte_range():
    """The non-piped child reads ``path``, ``start`` and ``split_length``
    from RUN_MAP's JSON (native/pipes/examples/wordcount-nopipe.cc)."""
    from tpumr_torch.mapred.split import FileSplit
    d = json.loads(json.dumps(FileSplit(path="file:///x", start=3,
                                        split_length=9).to_dict()))
    assert (d["path"], d["start"], d["split_length"]) == ("file:///x", 3, 9)


BOMB = """
    import time
    from tpumr_torch.pipes import child

    class M(child.Mapper):
        def map(self, ctx):
            hog = bytearray(300 << 20)
            hog[::4096] = b"x" * len(hog[::4096])
            time.sleep(30)

    class F(child.Factory):
        def create_mapper(self, ctx):
            return M()

    raise SystemExit(child.run_task(F()))
"""


def test_memory_manager_watches_and_kills_a_pipes_child(tmp_path):
    """tpumr/pipes/application.py:97-104: with
    ``mapred.task.limit.maxrss.mb`` the child is registered with the node's
    memory manager, killed above the limit, and unregistered at cleanup;
    the attempt fails with the child's death."""
    from tpumr_torch.mapred.api import OutputCollector, Reporter
    from tpumr_torch.mapred.node_health import GLOBAL_MEMORY_MANAGER
    from tpumr_torch.pipes.application import Application, PipesChildError
    from tpumr_torch.pipes.runner import _UplinkCollector
    conf = JobConf()
    conf.set("mapred.task.limit.maxrss.mb", 100)
    conf.set("tpumr.task.attempt.id", "attempt_x_0001_m_000000_0")
    killed = len(GLOBAL_MEMORY_MANAGER.killed)
    app = Application(conf, _script(tmp_path, "bomb", BOMB, "tpumr_torch"),
                      _UplinkCollector(OutputCollector(lambda k, v: None)),
                      Reporter())
    try:
        assert GLOBAL_MEMORY_MANAGER.watching() == \
            ["attempt_x_0001_m_000000_0"]
        app.downlink.start()
        app.downlink.run_map(b"{}", 1, piped_input=False)
        app.downlink.flush()
        with pytest.raises(PipesChildError, match="died mid-task"):
            app.wait_for_finish(timeout=20)
    finally:
        app.cleanup(kill=True)
    assert GLOBAL_MEMORY_MANAGER.killed[killed:] == \
        ["attempt_x_0001_m_000000_0"]
    assert GLOBAL_MEMORY_MANAGER.watching() == []
    assert app.process.returncode is not None
    assert not [t for t in threading.enumerate() if t.name == "pipes-uplink"]
