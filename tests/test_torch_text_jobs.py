"""The port's text jobs (examples wordcount, grep, pi and matmul through
tpumr_torch.mapred.local_runner) against the JAX package's on the same
inputs made from numpy seeds, on the CPU; and the three faults of the
output chain's error paths, each pinned with a filesystem stub.

The port runs with tpumr_torch.device=cpu. wordcount and grep are host code
in both packages, so their part files are byte-identical and their
framework counters equal key by key (the *_MILLIS timings aside), on every
route: the device runner (tpumr.local.run.on.tpu), the CPU batch runner and
the per-record mapper. pi's numpy paths draw from np.random.default_rng as
the JAX package's do and give its counts exactly; its torch path draws
from torch's Philox, which cannot repeat JAX's threefry bits, so it is
held as tests/test_ops.py::test_pi_kernel_reasonable holds the JAX kernel:
an estimate within 0.05 of pi. The matmul program's records are str() of
numpy blocks: byte-identical where both packages compute the same bits (the
per-record numpy mapper, or integer-valued operands, whose products and
sums are exact in any order).
"""

import hashlib
import io
import math
import os

import numpy as np
import pytest
import torch

import tpumr.examples.basic as jax_basic
from tpumr import examples as jax_examples
from tpumr.fs.filesystem import FileSystem as JaxFileSystem
from tpumr.io.recordbatch import RecordBatch as JaxRecordBatch
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr.ops import get_kernel as jax_get_kernel
from tpumr.ops import matmul as jax_matmul
from tpumr_torch import examples
from tpumr_torch.core.counters import BackendCounter, TaskCounter
from tpumr_torch.examples import basic
from tpumr_torch.fs.filesystem import FileSystem, Path
from tpumr_torch.fs.local import LocalFileSystem
from tpumr_torch.io.recordbatch import RecordBatch
from tpumr_torch.mapred import device_output, gpu_runner, local_runner
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job
from tpumr_torch.mapred.output_formats import _DenseNpyWriter
from tpumr_torch.ops import get_kernel, kmeans, matmul, pi, registry

TRICKY = (b"alpha beta\r\n\xff\xfe bad\ncaf\xc3\xa9\r\r\n\n"
          b"x\ry z word0042\n\xe2\x82 cut\nlast word0007 no newline")


@pytest.fixture(autouse=True)
def _fresh():
    FileSystem.clear_cache()
    gpu_runner.clear_split_caches()
    matmul.clear_b_cache()
    jax_matmul.clear_b_cache()
    yield
    FileSystem.clear_cache()
    gpu_runner.clear_split_caches()
    matmul.clear_b_cache()


@pytest.fixture
def results(monkeypatch):
    """The JobResults of every example job, per package."""
    got = {"port": [], "jax": []}
    real, jreal = basic.run_job, jax_basic.run_job
    monkeypatch.setattr(basic, "run_job", lambda conf: got["port"].append(
        real(conf)) or got["port"][-1])
    monkeypatch.setattr(jax_basic, "run_job", lambda conf: got["jax"].append(
        jreal(conf)) or got["jax"][-1])
    return got


def _write_text(dirpath, lines=1500):
    """bench.py:572-582's text at a small size (4,096 words from
    default_rng(1), 12 a line, no final newline) and a file of TRICKY
    lines (CRLF, lone CR, invalid UTF-8)."""
    os.makedirs(dirpath, exist_ok=True)
    words = [f"word{i:04d}".encode() for i in range(4096)]
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 4096, size=(lines, 12))
    with open(os.path.join(dirpath, "text.txt"), "wb") as f:
        f.write(b"\n".join(b" ".join(words[j] for j in r) for r in idx))
    with open(os.path.join(dirpath, "tricky.txt"), "wb") as f:
        f.write(TRICKY * 3)


def _counters(result):
    return {g: {n: v for n, v in names.items() if not n.endswith("_MILLIS")}
            for g, names in result.counters.to_dict().items()}


def _assert_same_jobs(results):
    assert len(results["port"]) == len(results["jax"]) > 0
    for res, jres in zip(results["port"], results["jax"]):
        assert res.num_maps == jres.num_maps
        assert _counters(res) == _counters(jres)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# --------------------------------------------------------- wordcount, grep


@pytest.mark.parametrize("program,extra", [
    ("wordcount", []),
    ("grep", ["word00[0-9]{2}"]),
    ("grep", ["(w)ord00([0-9])[0-9]", "2"]),
    ("grep", ["caf.|y z"]),      # a match that ends inside a character
])
@pytest.mark.parametrize("mode", ["device", "cpu_only"])
def test_text_examples_match_jax(tmp_path, results, program, extra, mode):
    """Mirrors tpumr/examples/basic.py::wordcount and ::grep (the kernel on
    the device runner, or --cpu-only's per-record mapper): part files
    byte-identical, framework counters equal key by key."""
    _write_text(tmp_path / "in")
    common = ["-D", "mapred.map.tasks=4"] + \
        (["--cpu-only"] if mode == "cpu_only" else [])
    inp = f"file://{tmp_path}/in"
    assert examples.main([program, inp, f"file://{tmp_path}/port", *extra,
                          *common, "-D", "tpumr_torch.device=cpu"]) == 0
    assert jax_examples.main([program, inp, f"file://{tmp_path}/jax", *extra,
                              *common]) == 0
    got = _read(tmp_path / "port" / "part-00000")
    assert got == _read(tmp_path / "jax" / "part-00000")
    assert len(got.splitlines()) >= 2
    _assert_same_jobs(results)
    res = results["port"][0]
    backend = {"device": BackendCounter.TPU_MAP_TASKS,
               "cpu_only": BackendCounter.CPU_MAP_TASKS}[mode]
    assert res.counters.value(BackendCounter.GROUP, backend) == res.num_maps


@pytest.mark.parametrize("program", ["wordcount", "grep"])
@pytest.mark.parametrize("route", ["cpu_batch", "per_record"])
def test_text_jobs_on_cpu_slots_match_jax(tmp_path, program, route):
    """The CPU slots' two runners (tpumr/mapred/map_task.py::
    _cpu_runner_class): a kernel with a host twin (wordcount) runs the
    batch runner (CPU_BATCH_MAP_TASKS), and tpumr.cpu.batch.map=false or a
    kernel without one (grep) the per-record mapper over the counted
    reader; both as the JAX package, byte for byte and counter for
    counter."""
    _write_text(tmp_path / "in")
    out = {}
    for conf, pkg in ((JobConf(), "tpumr_torch"), (JaxJobConf(), "tpumr")):
        conf.set_input_paths(f"file://{tmp_path}/in")
        conf.set_output_path(f"file://{tmp_path}/out-{pkg}")
        fmt = "RawTextInputFormat" if program == "wordcount" else \
            "TextInputFormat"
        conf.set("mapred.input.format.class",
                 f"{pkg}.mapred.input_formats.{fmt}")
        conf.set("mapred.map.tasks", 3)
        conf.set_map_kernel(program)
        mapper = {"wordcount": "wordcount.WordCountCpuMapper",
                  "grep": "grep.GrepCpuMapper"}[program]
        conf.set("mapred.mapper.class", f"{pkg}.ops.{mapper}")
        conf.set("tpumr.grep.pattern", "word0[0-4][0-9]{2}")
        for key in ("mapred.reducer.class", "mapred.combiner.class"):
            conf.set(key, f"{pkg}.examples.basic.LongSumReducer")
        if route == "per_record":
            conf.set("tpumr.cpu.batch.map", False)
        out[pkg] = conf
    out["tpumr_torch"].set("tpumr_torch.device", "cpu")
    res = run_job(out["tpumr_torch"])
    jres = jax_run_job(out["tpumr"])
    assert _read(tmp_path / "out-tpumr_torch" / "part-00000") == \
        _read(tmp_path / "out-tpumr" / "part-00000")
    assert _counters(res) == _counters(jres)
    # grep has no host twin (map_batch_cpu): its CPU maps are per-record
    # on either route, as in the JAX package
    assert res.counters.value(
        BackendCounter.GROUP, BackendCounter.CPU_BATCH_MAP_TASKS) == \
        (res.num_maps if (route, program) == ("cpu_batch", "wordcount")
         else 0)


def test_host_kernels_on_cuda_take_the_device_runner(tmp_path, monkeypatch):
    """Mirrors the map_batch branch of tpumr/mapred/tpu_runner.py::
    TpuMapRunner.run. On cuda a host kernel's maps take the device runner
    whatever tpumr.local.run.on.tpu says (local_runner.maps_on_device): no
    window
    (wordcount has no launch, prelaunch_device_maps gives None), each map
    one by one, counted as TPU_MAP_TASKS and none as a CPU map; output and
    counters as the JAX package's device runner. The tasks compute on the
    CPU here; only the job's routing sees cuda."""
    monkeypatch.setattr(local_runner, "select_device",
                        lambda conf: torch.device("cuda", 0))
    _write_text(tmp_path / "in")
    confs = []
    for conf, pkg in ((JobConf(), "tpumr_torch"), (JaxJobConf(), "tpumr")):
        conf.set_input_paths(f"file://{tmp_path}/in")
        conf.set_output_path(f"file://{tmp_path}/out-{pkg}")
        conf.set("mapred.input.format.class",
                 f"{pkg}.mapred.input_formats.RawTextInputFormat")
        conf.set_map_kernel("wordcount")
        for key in ("mapred.reducer.class", "mapred.combiner.class"):
            conf.set(key, f"{pkg}.examples.basic.LongSumReducer")
        confs.append(conf)
    conf, jconf = confs
    conf.set("tpumr_torch.device", "cpu")
    jconf.set("tpumr.local.run.on.tpu", True)
    assert gpu_runner.prelaunch_device_maps(conf, []) is None
    res = run_job(conf)
    jres = jax_run_job(jconf)
    assert res.counters.value(BackendCounter.GROUP,
                              BackendCounter.TPU_MAP_TASKS) == res.num_maps
    assert res.counters.value(BackendCounter.GROUP,
                              BackendCounter.CPU_MAP_TASKS) == 0
    assert _counters(res) == _counters(jres)
    assert _read(tmp_path / "out-tpumr_torch" / "part-00000") == \
        _read(tmp_path / "out-tpumr" / "part-00000")


# ---------------------------------------------------------------- matmul


@pytest.mark.parametrize("mode,rows,extra", [
    ("cpu_only", 8, []),
    ("cpu_only", 8, ["-r", "0"]),
    ("device", 10, []),          # 10 x 40 = 400 elements, printed in full
    ("device", 32, ["-r", "0"]),  # 32 x 40: abbreviated with "..."
])
def test_examples_matmul_matches_jax(tmp_path, results, mode, rows, extra):
    """Mirrors tpumr/examples/basic.py::matmul: one str() of a block (a row
    with --cpu-only) per record through the text output, with the default
    reduce or map-only; part files byte-identical, counters equal. The
    device route (bf16 by default) takes integer-valued operands, which
    bf16 holds exactly and whose products sum exactly in any order."""
    rng = np.random.default_rng(4)
    if mode == "device":
        a = rng.integers(-4, 5, size=(64, 24)).astype(np.float32)
        b = rng.integers(-4, 5, size=(24, 40)).astype(np.float32)
    else:
        a = rng.standard_normal((24, 16), dtype=np.float32)
        b = rng.standard_normal((16, 40), dtype=np.float32)
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    args = [f"file://{tmp_path}/a.npy", f"file://{tmp_path}/b.npy"]
    common = ["--split-rows", str(rows), *extra] + \
        (["--cpu-only"] if mode == "cpu_only" else [])
    assert examples.main(["matmul", *args, f"file://{tmp_path}/port",
                          *common, "-D", "tpumr_torch.device=cpu"]) == 0
    assert jax_examples.main(["matmul", *args, f"file://{tmp_path}/jax",
                              *common]) == 0
    parts = sorted(p for p in os.listdir(tmp_path / "jax")
                   if p.startswith("part-"))
    assert sorted(p for p in os.listdir(tmp_path / "port")
                  if p.startswith("part-")) == parts
    assert len(parts) == (1 if not extra else -(-a.shape[0] // rows))
    for p in parts:
        assert _read(tmp_path / "port" / p) == _read(tmp_path / "jax" / p)
    text = b"".join(_read(tmp_path / "port" / p) for p in parts)
    assert (b"..." in text) is (mode == "device" and rows * 40 > 1000)
    _assert_same_jobs(results)


# -------------------------------------------------------------------- pi


def _pi_part(fs, work):
    out = {}
    for st in fs.list_files(f"{work}/out"):
        if st.path.name.startswith("part"):
            for line in fs.read_bytes(st.path).decode().splitlines():
                k, _, v = line.partition("\t")
                out[k] = int(v)
    return out


def test_pi_cpu_only_matches_jax_exactly(tmp_path, results, capsys):
    """Mirrors tpumr/examples/basic.py::pi --cpu-only (PiCpuMapper, one map
    per NLineInputFormat line, seeds from 1000): numpy draws, so the part
    file, the printed estimate and the counters are the JAX package's."""
    work = f"mem://{tmp_path}/pi"
    assert examples.main(["pi", "5", "30000", "--work", work,
                          "--cpu-only"]) == 0
    port_out = capsys.readouterr().out
    assert jax_examples.main(["pi", "5", "30000", "--work", work,
                              "--cpu-only"]) == 0
    assert capsys.readouterr().out == port_out
    assert port_out.startswith("Estimated value of Pi is ")
    got = _pi_part(FileSystem.get(work), work)
    assert got == _pi_part(JaxFileSystem.get(work), work)
    assert got["total"] == 150_000
    _assert_same_jobs(results)


def test_pi_cpu_batch_matches_jax_exactly(tmp_path):
    """Mirrors tpumr/ops/pi.py::PiSamplerKernel.map_batch_cpu: the kernel on
    a CPU slot (no tpumr.local.run.on.tpu) runs its numpy twin over the
    records the reader drained; inside equals the JAX package's."""
    (tmp_path / "seeds.txt").write_text(
        "".join(f"{m} {20_000 + m}\n" for m in range(6)))
    res = []
    for conf, pkg, run in ((JobConf(), "tpumr_torch", run_job),
                           (JaxJobConf(), "tpumr", jax_run_job)):
        conf.set_input_paths(f"file://{tmp_path}/seeds.txt")
        conf.set_output_path(f"file://{tmp_path}/out-{pkg}")
        conf.set("mapred.input.format.class",
                 f"{pkg}.mapred.input_formats.NLineInputFormat")
        conf.set("mapred.line.input.format.linespermap", 2)
        conf.set_map_kernel("pi-sampler")
        conf.set("mapred.reducer.class",
                 f"{pkg}.examples.basic.LongSumReducer")
        conf.set("tpumr_torch.device", "cpu")
        res.append(run(conf))
    assert _read(tmp_path / "out-tpumr_torch" / "part-00000") == \
        _read(tmp_path / "out-tpumr" / "part-00000")
    assert _counters(res[0]) == _counters(res[1])
    assert res[0].counters.value(BackendCounter.GROUP,
                                 BackendCounter.CPU_BATCH_MAP_TASKS) == 3


def test_pi_torch_path_within_the_reference_tolerance(tmp_path, results,
                                                      monkeypatch, capsys):
    """Mirrors tests/test_ops.py::test_pi_kernel_reasonable on the port's
    torch path (CPU tensors): the kernel on two 20,000-sample blocks, then
    the examples pi job on the device runner. Each map takes the per-task
    path (NLineInputFormat has no read_batch, so no window) with one fetch;
    the estimates lie within 0.05 of pi, a relaunch counts the same, and
    the counters equal the JAX package's device job's."""
    conf = JobConf()
    conf.set("tpumr_torch.device", "cpu")
    batch = RecordBatch.from_values([b"1 20000", b"2 20000"])
    out = dict(get_kernel("pi-sampler").map_batch(batch, conf, None))
    assert out["total"] == 40_000
    assert abs(4.0 * out["inside"] / out["total"] - math.pi) < 0.05
    assert dict(get_kernel("pi-sampler").map_batch(batch, conf, None)) == out
    jout = dict(jax_get_kernel("pi-sampler").map_batch(
        JaxRecordBatch.from_values([b"1 20000", b"2 20000"]), JaxJobConf(),
        None))
    assert jout["total"] == 40_000

    fetches = []
    real = registry.fetch_to_host
    monkeypatch.setattr(registry, "fetch_to_host",
                        lambda states: (fetches.append(len(states)),
                                        real(states))[1])
    launches0 = pi.count_inside.launches
    work = f"mem://{tmp_path}/pi"
    assert examples.main(["pi", "4", "20000", "--work", work, "-D",
                          "tpumr_torch.device=cpu"]) == 0
    assert jax_examples.main(["pi", "4", "20000", "--work", work]) == 0
    for line in capsys.readouterr().out.splitlines():
        assert abs(float(line.rsplit(" ", 1)[1]) - math.pi) < 0.05
    assert fetches == [1, 1, 1, 1]
    assert pi.count_inside.launches - launches0 == 4
    res = results["port"][0]
    assert res.counters.value(BackendCounter.GROUP,
                              BackendCounter.TPU_MAP_TASKS) == 4
    assert res.counters.value(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.MAP_INPUT_RECORDS) == 4
    _assert_same_jobs(results)


def test_pi_seeds_are_masked_to_uint32():
    """Mirrors the uint32 mask of tpumr/ops/pi.py::PiSamplerKernel.
    map_batch_launch: seeds -1 and 2**32 + 5 count as 2**32 - 1 and 5,
    alone and through the kernel."""
    cpu = torch.device("cpu")
    for seed, same in ((-1, 2**32 - 1), (2**32 + 5, 5)):
        assert int(pi.count_inside(seed, 5_000, cpu)) == \
            int(pi.count_inside(same, 5_000, cpu))
    conf = JobConf()
    conf.set("tpumr_torch.device", "cpu")
    kernel = get_kernel("pi-sampler")
    wide = dict(kernel.map_batch(RecordBatch.from_values(
        [b"-1 3000", f"{2**32 + 5} 3000".encode()]), conf, None))
    masked = dict(kernel.map_batch(RecordBatch.from_values(
        [f"{2**32 - 1} 3000".encode(), b"5 3000"]), conf, None))
    assert wide == masked and wide["total"] == 6000


# --------------------------------------------------------- device rule


@pytest.mark.parametrize("program", ["wordcount", "grep", "pi", "matmul"])
def test_new_programs_raise_without_cuda(tmp_path, monkeypatch, program):
    """The port's device rule (tpumr_torch/device.py::select_device, the
    counterpart of tpumr/mapred/tpu_runner.py::_select_device) under the
    programs of tpumr/examples/basic.py: with no CUDA and no
    tpumr_torch.device=cpu the program raises and runs nothing on the CPU
    (no part file)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_text(tmp_path / "in")
    np.save(tmp_path / "a.npy", np.ones((4, 3), np.float32))
    np.save(tmp_path / "b.npy", np.ones((3, 2), np.float32))
    out = f"file://{tmp_path}/out"
    argv = {"wordcount": [f"file://{tmp_path}/in", out],
            "grep": [f"file://{tmp_path}/in", out, "word"],
            "pi": ["2", "100", "--work", f"file://{tmp_path}/pi"],
            "matmul": [f"file://{tmp_path}/a.npy",
                       f"file://{tmp_path}/b.npy", out]}[program]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        examples.main([program, *argv])
    assert not os.path.exists(tmp_path / "out" / "part-00000")
    assert not os.path.exists(tmp_path / "pi" / "out" / "part-00000")


# ------------------------------------- the output chain's error paths


class _FailingOpen(LocalFileSystem):
    """Opens ``ok_opens`` files, then raises OSError."""

    def __init__(self, ok_opens):
        self.ok_opens = ok_opens

    def open(self, path):
        if self.ok_opens <= 0:
            raise OSError("stub: read refused")
        self.ok_opens -= 1
        return super().open(path)


@pytest.mark.parametrize("ok_opens", [0, 1])
def test_lookup_read_error_means_no_resident_image(tmp_path, monkeypatch,
                                                   ok_opens):
    """Mirrors tpumr/mapred/device_output.py::lookup (:133-142, :156-165):
    an OSError from the fingerprint read (ok_opens=0) or the sha1 read
    (ok_opens=1) gives None, and the consumer reads the file itself,
    where the port raised before."""
    monkeypatch.setattr(device_output, "_published_any", False)
    monkeypatch.setattr(device_output, "_verified", set())
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    buf = io.BytesIO()
    np.save(buf, arr)
    data = buf.getvalue()
    path = tmp_path / "part-00000.npy"
    path.write_bytes(data)
    mtime = os.stat(path).st_mtime
    conf = JobConf()
    rows = torch.from_numpy(arr)
    head, tail, size = device_output.head_tail(data)
    device_output.publish(conf, rows, head, tail, size, mtime,
                          full_sha=hashlib.sha1(data).hexdigest())
    cpu = torch.device("cpu")
    assert device_output.lookup(conf, cpu, _FailingOpen(ok_opens),
                                str(path), size, mtime) is None
    assert device_output.lookup(conf, cpu, LocalFileSystem(), str(path),
                                size, mtime) is rows


def test_dense_writer_without_status_writes_and_publishes_nothing(
        tmp_path, monkeypatch):
    """Mirrors tpumr/mapred/output_formats.py::_DenseNpyWriter.close
    (:153-156): when get_status of the written part raises, the part is
    written and the offered rows are claimed but not published; the
    attempt does not fail."""

    class _NoStatus(LocalFileSystem):
        def get_status(self, path):
            raise OSError("stub: status refused")

    monkeypatch.setattr(device_output, "_published_any", False)
    conf = JobConf()
    conf.set("tpumr.task.attempt.id", "attempt_local_0001_m_000000_0")
    arr = np.ones((2, 3), np.float32)
    writer = _DenseNpyWriter(conf, _NoStatus(),
                             Path(f"file://{tmp_path}/part-00000.npy"))
    device_output.offer("attempt_local_0001_m_000000_0",
                        torch.from_numpy(arr))
    writer.write(0, arr)
    writer.close()
    np.testing.assert_array_equal(np.load(tmp_path / "part-00000.npy"), arr)
    assert device_output.claim("attempt_local_0001_m_000000_0") is None
    assert device_output._published_any is False


def test_update_reducer_ignores_a_failed_temp_delete(tmp_path, monkeypatch):
    """Mirrors tpumr/ops/kmeans.py::KMeansCentroidUpdateReducer.close
    (:336-340): a filesystem that refuses the rename and then fails to
    delete the temp file leaves the temp file, and the attempt succeeds."""

    class _Refusing(LocalFileSystem):
        def rename(self, src, dst):
            return False

        def delete(self, path, recursive=False):
            raise OSError("stub: delete refused")

    from tpumr_torch.mapred.api import OutputCollector, Reporter
    monkeypatch.setitem(FileSystem._registry, "refusing", _Refusing)
    np.save(tmp_path / "c0.npy", np.zeros((2, 2), np.float32))
    conf = JobConf()
    conf.set("tpumr.kmeans.centroids", f"file://{tmp_path}/c0.npy")
    conf.set("tpumr.kmeans.centroids.out", f"refusing://{tmp_path}/c1.npy")
    conf.set("tpumr_torch.device", "cpu")
    red = kmeans.KMeansCentroidUpdateReducer()
    red.configure(conf)
    red.reduce(1, iter([(np.array([2.0, 4.0]), 2)]),
               OutputCollector(lambda k, v: None), Reporter())
    try:
        red.close()
    finally:
        kmeans.clear_pipeline_caches()
    assert sorted(os.listdir(tmp_path)) == ["c0.npy", "c1.npy._local.tmp"]
