"""The port's streaming tier (tpumr_torch.streaming) against the JAX
package's (tpumr.streaming) on the same inputs: script mappers, reducers
and combiners over pipes, the stderr reporter protocol, the conf in the
child's environment, typed bytes, ``-reducer aggregate`` through the
``streaming`` command, and the child's end on every path.

Each test names the test of tests/test_streaming.py or tests/test_lib.py
it mirrors. The port runs with tpumr_torch.device=cpu; part files are
compared byte for byte, typed-bytes frames in both directions (the port's
writer to the JAX package's reader, and back).
"""

import io
import os
import struct
import subprocess
import sys
import time

import pytest

from tpumr.cli import main as jax_cli_main
from tpumr.io import sequencefile as jax_sequencefile
from tpumr.mapred.job_client import JobClient as JaxJobClient
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.output_formats import \
    SequenceFileOutputFormat as JaxSequenceFileOutputFormat
from tpumr.streaming import setup_stream_job as jax_setup_stream_job
from tpumr.streaming import typedbytes as jax_tb
from tpumr_torch.cli import main as cli_main
from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.io import sequencefile
from tpumr_torch.mapred.api import OutputCollector, Reporter, TaskKilledError
from tpumr_torch.mapred.job_client import run_job
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.output_formats import SequenceFileOutputFormat
from tpumr_torch.streaming import (StreamMapRunner, StreamReducer,
                                   setup_stream_job)
from tpumr_torch.streaming import typedbytes as tb

PY = sys.executable
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WC_MAPPER = (f"{PY} -c \"import sys\n"
             "for line in sys.stdin:\n"
             "    parts = line.rstrip().split('\\t', 1)\n"
             "    text = parts[1] if len(parts) > 1 else parts[0]\n"
             "    for w in text.split():\n"
             "        print(w + '\\t1')\n"
             "sys.stderr.write('reporter:counter:WC,MAP_LINES,1\\n')\n"
             "sys.stderr.write('reporter:status:mapped\\n')\"")

WC_REDUCER = (f"{PY} -c \"import sys\n"
              "cur, total = None, 0\n"
              "for line in sys.stdin:\n"
              "    k, v = line.rstrip().split('\\t')\n"
              "    if k != cur:\n"
              "        if cur is not None:\n"
              "            print(cur + '\\t' + str(total))\n"
              "        cur, total = k, 0\n"
              "    total += int(v)\n"
              "if cur is not None:\n"
              "    print(cur + '\\t' + str(total))\n"
              "sys.stderr.write('reporter:counter:WC,CHILDREN,1\\n')\"")

#: typed-bytes children through each package's own module
TB_MAPPER = (f"{PY} -c \"import sys\n"
             "sys.path[:0] = {path!r}\n"
             "from {pkg}.streaming.typedbytes import read_pairs, write_pair\n"
             "for k, v in read_pairs(sys.stdin.buffer):\n"
             "    v = v.encode() if isinstance(v, str) else v\n"
             "    write_pair(sys.stdout.buffer, v, "
             "bytes([0]) + v + b'\\\\n' + v)\n"
             "sys.stdout.buffer.flush()\"")

TB_REDUCER = (f"{PY} -c \"import sys\n"
              "sys.path[:0] = {path!r}\n"
              "from {pkg}.streaming.typedbytes import read_pairs, write_pair\n"
              "for k, v in read_pairs(sys.stdin.buffer):\n"
              "    write_pair(sys.stdout.buffer, k, v)\n"
              "sys.stdout.buffer.flush()\"")

PKGS = {"jax": (JaxJobConf, jax_setup_stream_job,
                lambda conf: JaxJobClient(conf).run_job(conf)),
        "port": (JobConf, setup_stream_job, run_job)}


def _text(seed: int, lines: int) -> bytes:
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 30, size=(lines, 5))
    return b"".join((" ".join(f"t{i}" for i in row) + "\n").encode()
                    for row in ids)


def _run(pkg, tmp_path, name, inp, reduces=1, **stream):
    conf_cls, setup, runner = PKGS[pkg]
    conf = conf_cls()
    if pkg == "port":
        conf.set("tpumr_torch.device", "cpu")
    conf.set_input_paths(f"file://{inp}")
    out = tmp_path / f"{name}-{pkg}"
    conf.set_output_path(f"file://{out}")
    conf.set_num_reduce_tasks(reduces)
    extra = stream.pop("conf", {})
    for k, v in extra.items():
        conf.set(k, v)
    setup(conf, **stream)
    result = runner(conf)
    assert result.successful
    return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))
            if f.startswith("part-")}, result


def _both(tmp_path, name, inp, reduces=1, **stream):
    jf, jr = _run("jax", tmp_path, name, inp, reduces, **dict(stream))
    pf, pr = _run("port", tmp_path, name, inp, reduces, **dict(stream))
    assert pf == jf
    return pf, pr, jr


def test_streaming_wordcount(tmp_path):
    """tests/test_streaming.py::test_streaming_wordcount: the same part
    file, and the reporter lines counted."""
    (tmp_path / "in.txt").write_bytes(_text(1, 400))
    files, port, jax = _both(tmp_path, "wc", tmp_path / "in.txt",
                             mapper=WC_MAPPER, reducer=WC_REDUCER)
    assert files["part-00000"].count(b"\n") == 30
    assert port.counters.value("WC", "MAP_LINES") == \
        jax.counters.value("WC", "MAP_LINES") >= 1
    assert port.counters.value("WC", "CHILDREN") == 1


def test_streaming_cat_identity_and_env(tmp_path):
    """tests/test_streaming.py::test_streaming_cat_identity_and_env: the
    conf's keys reach the child's environment, dots as underscores."""
    (tmp_path / "in.txt").write_bytes(b"one\ntwo\n")
    env_mapper = (f"{PY} -c \"import sys, os\n"
                  "for line in sys.stdin:\n"
                  "    sys.stdout.write(line)\n"
                  "print('jobname\\t' + os.environ['mapred_job_name'])\"")
    files, _, _ = _both(tmp_path, "env", tmp_path / "in.txt", reduces=0,
                        mapper=env_mapper,
                        conf={"mapred.job.name": "envcheck"})
    assert files["part-00000"] == b"one\t\ntwo\t\njobname\tenvcheck\n"


def test_streaming_failing_child_fails_task(tmp_path):
    """tests/test_streaming.py::test_streaming_failing_child_fails_task."""
    (tmp_path / "in.txt").write_bytes(b"a\n" * 5000)
    conf = JobConf()
    conf.set("tpumr_torch.device", "cpu")
    conf.set_input_paths(f"file://{tmp_path}/in.txt")
    conf.set_output_path(f"file://{tmp_path}/out")
    conf.set_num_reduce_tasks(0)
    setup_stream_job(conf, mapper=f"{PY} -c \"import sys; sys.exit(7)\"")
    with pytest.raises(RuntimeError, match="rc=7"):
        run_job(conf)


def test_streaming_combiner_runs_a_child_per_combine(tmp_path):
    """tests/test_streaming.py::test_streaming_combiner, with the map's
    buffer spilling several times: a combiner child for each spill and
    the merge, the same counters as the JAX package's."""
    (tmp_path / "in.txt").write_bytes(b"k k k\nk j k\n" * 200)
    files, port, jax = _both(
        tmp_path, "comb", tmp_path / "in.txt", mapper=WC_MAPPER,
        reducer=WC_REDUCER, combiner=WC_REDUCER,
        conf={"io.sort.mb": 1, "io.sort.spill.percent": 0.01})
    assert files["part-00000"] == b"j\t200\nk\t1000\n"
    group = TaskCounter.FRAMEWORK_GROUP
    for name in (TaskCounter.COMBINE_INPUT_RECORDS,
                 TaskCounter.COMBINE_OUTPUT_RECORDS):
        assert port.counters.value(group, name) == \
            jax.counters.value(group, name)
    # one child for each spill and the merge, and one reduce child
    assert port.counters.value("WC", "CHILDREN") == \
        jax.counters.value("WC", "CHILDREN") > 3


def test_streaming_reducer_aggregate_through_the_command(tmp_path):
    """tests/test_lib.py::test_streaming_reducer_aggregate: the
    ``streaming`` command with ``-reducer aggregate`` in both packages."""
    mapper = tmp_path / "map.py"
    mapper.write_text("import sys\n"
                      "for line in sys.stdin:\n"
                      "    for w in line.split():\n"
                      "        print(f'LongValueSum:{w}\\t1')\n")
    (tmp_path / "in.txt").write_bytes(_text(2, 300))
    for pkg, main in (("jax", jax_cli_main), ("port", cli_main)):
        generic = ["-D", "tpumr_torch.device=cpu"] if pkg == "port" else []
        assert main(generic + [
            "streaming", "-input", f"file://{tmp_path}/in.txt",
            "-output", f"file://{tmp_path}/agg-{pkg}",
            "-mapper", f"{PY} {mapper}", "-reducer", "aggregate"]) == 0
    got = (tmp_path / "agg-port" / "part-00000").read_bytes()
    assert got == (tmp_path / "agg-jax" / "part-00000").read_bytes()
    assert sum(int(l.split(b"\t")[1]) for l in got.splitlines()) == 1500


def test_stream_job_builder(tmp_path):
    """StreamJob, the builder of tpumr/streaming/stream_job.py: the same
    part file as the JAX package's builder."""
    from tpumr.streaming import StreamJob as JaxStreamJob
    from tpumr_torch.streaming import StreamJob
    (tmp_path / "in.txt").write_bytes(_text(3, 100))
    parts = {}
    for pkg, builder in (("jax", JaxStreamJob), ("port", StreamJob)):
        job = builder().set_mapper(WC_MAPPER).set_reducer(WC_REDUCER) \
            .set_combiner(WC_REDUCER)
        if pkg == "port":
            job.conf.set("tpumr_torch.device", "cpu")
        job.conf.set_input_paths(f"file://{tmp_path}/in.txt")
        job.conf.set_output_path(f"file://{tmp_path}/sj-{pkg}")
        assert job.run().successful
        parts[pkg] = (tmp_path / f"sj-{pkg}" / "part-00000").read_bytes()
    assert parts["port"] == parts["jax"] and parts["port"].count(b"\n") == 30


# ------------------------------------------------------------- typed bytes

TB_VALUES = [
    b"",
    b"embedded\x00nul\ttab\nnewline\xff\xfe",
    True, False,
    0, -1, 2**31 - 1, -(2**31), 2**31, -(2**63),
    3.5, -0.0,
    "unicode é中",
    (1, "two", b"\x00three"),
    [b"\n", [1, 2], "nested"],
    {b"k\x00": b"v\n", "n": 1},
]


@pytest.mark.parametrize("value", TB_VALUES, ids=range(len(TB_VALUES)))
def test_typedbytes_frames_equal_both_ways(value):
    """tests/test_streaming.py::test_typedbytes_roundtrip_all_types: the
    port's frame of each value is the JAX package's, byte for byte, and
    each package reads the other's."""
    port, jax = io.BytesIO(), io.BytesIO()
    tb.write_typed(port, value)
    jax_tb.write_typed(jax, value)
    assert port.getvalue() == jax.getvalue()
    assert jax_tb.read_typed(io.BytesIO(port.getvalue())) == value
    assert tb.read_typed(io.BytesIO(jax.getvalue())) == value


def test_typedbytes_wire_format_is_reference_compatible():
    """tests/test_streaming.py::test_typedbytes_wire_format_is_reference_
    compatible, and BYTE and FLOAT frames (written by no Python value)
    read as the JAX package reads them."""
    def enc(v):
        b = io.BytesIO()
        tb.write_typed(b, v)
        return b.getvalue()

    assert enc(b"ab") == b"\x00" + struct.pack(">i", 2) + b"ab"
    assert enc(True) == b"\x02\x01"
    assert enc(7) == b"\x03" + struct.pack(">i", 7)
    assert enc(2**40) == b"\x04" + struct.pack(">q", 2**40)
    assert enc(1.5) == b"\x06" + struct.pack(">d", 1.5)
    assert enc("hi") == b"\x07" + struct.pack(">i", 2) + b"hi"
    assert enc([1]) == b"\x09" + enc(1) + b"\xff"
    for frame in (b"\x01\xfe", b"\x05" + struct.pack(">f", 0.25)):
        assert tb.read_typed(io.BytesIO(frame)) == \
            jax_tb.read_typed(io.BytesIO(frame))
    with pytest.raises(tb.TypedBytesError):
        tb.write_typed(io.BytesIO(), object())


@pytest.mark.parametrize("stream", [b"\x07\x00\x00", b"\x03\x00\x00\x00\x01"])
def test_typedbytes_truncated_pairs_raise(stream):
    """tests/test_streaming.py::test_typedbytes_protocol_error_fails_task's
    reader: a key cut in its frame, or a lone last key, raises in both."""
    for mod in (tb, jax_tb):
        with pytest.raises(mod.TypedBytesError):
            list(mod.read_pairs(io.BytesIO(stream)))


def test_typedbytes_streaming_job_binary_safe(tmp_path):
    """tests/test_streaming.py::test_typedbytes_streaming_job_binary_safe:
    values with newlines and NULs through both children, the same
    records out of both packages."""
    (tmp_path / "in.txt").write_bytes(b"r1\nr2\nr3\n")
    recs = {}
    for pkg in ("jax", "port"):
        conf_cls, setup, runner = PKGS[pkg]
        conf = conf_cls()
        if pkg == "port":
            conf.set("tpumr_torch.device", "cpu")
        conf.set_input_paths(f"file://{tmp_path}/in.txt")
        conf.set_output_path(f"file://{tmp_path}/tb-{pkg}")
        conf.set_num_reduce_tasks(1)
        name = "tpumr_torch" if pkg == "port" else "tpumr"
        conf.set_output_format(SequenceFileOutputFormat if pkg == "port"
                               else JaxSequenceFileOutputFormat)
        path = [REPO] + list(sys.path)
        setup(conf, mapper=TB_MAPPER.format(path=path, pkg=name),
              reducer=TB_REDUCER.format(path=path, pkg=name),
              io="typedbytes")
        assert runner(conf).successful
        reader_mod = sequencefile if pkg == "port" else jax_sequencefile
        with open(tmp_path / f"tb-{pkg}" / "part-00000", "rb") as f:
            recs[pkg] = list(reader_mod.Reader(f))
    assert recs["port"] == recs["jax"] == [
        (f"r{i}".encode(), b"\x00" + f"r{i}".encode() + b"\n" +
         f"r{i}".encode()) for i in (1, 2, 3)]


def test_typedbytes_protocol_error_fails_task(tmp_path):
    """tests/test_streaming.py::test_typedbytes_protocol_error_fails_task."""
    (tmp_path / "in.txt").write_bytes(b"a\n")
    conf = JobConf()
    conf.set("tpumr_torch.device", "cpu")
    conf.set_input_paths(f"file://{tmp_path}/in.txt")
    conf.set_output_path(f"file://{tmp_path}/out")
    conf.set_num_reduce_tasks(0)
    bad = (f"{PY} -c \"import sys\n"
           f"sys.path[:0] = {[REPO] + list(sys.path)!r}\n"
           "from tpumr_torch.streaming.typedbytes import write_typed\n"
           "write_typed(sys.stdout.buffer, b'lone-key')\n"
           "sys.stdout.buffer.flush()\"")
    setup_stream_job(conf, mapper=bad, io="typedbytes")
    with pytest.raises(RuntimeError, match="protocol error"):
        run_job(conf)


# ------------------------------------------------------- the child's end


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


SLEEPER = f"{PY} -c \"import time; time.sleep(60)\""


def test_failed_reduce_kills_its_child():
    """The abort path of a failed reduce (reduce_task's ``abort``): the
    reducer's child is killed and reaped, not waited for."""
    conf = JobConf()
    conf.set("stream.reduce.command", SLEEPER)
    r = StreamReducer()
    r.configure(conf)
    r.reduce("k", iter(["v"]), OutputCollector(lambda k, v: None),
             Reporter())
    proc = r._child.proc
    t0 = time.monotonic()
    r.abort()
    assert time.monotonic() - t0 < 5
    assert proc.returncode is not None and _gone(proc.pid)


def test_killed_map_ends_its_child(monkeypatch):
    """A map whose attempt is killed while its child still runs: the wait
    for the child polls the kill flag, kills and reaps it."""
    import tpumr_torch.streaming.pipe_runner as pr
    conf = JobConf()
    conf.set("stream.map.command", SLEEPER)
    conf.set("stream.map.input.ignoreKey", True)
    started = []
    real_popen = subprocess.Popen

    def popen(*a, **kw):
        started.append(real_popen(*a, **kw))
        return started[-1]

    monkeypatch.setattr(pr.subprocess, "Popen", popen)
    runner = StreamMapRunner()
    runner.configure(conf)
    t0 = time.monotonic()
    with pytest.raises(TaskKilledError):
        runner.run(iter([(0, "x")]), OutputCollector(lambda k, v: None),
                   Reporter(abort_check=lambda: bool(started)))
    assert time.monotonic() - t0 < 5
    assert started[0].returncode is not None and _gone(started[0].pid)
