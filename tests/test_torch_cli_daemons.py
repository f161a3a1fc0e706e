"""The port's daemons from its command line, each in a process of its own,
on the CPU: python -m tpumr_torch.cli jobtracker and tasktracker
(tpumr/cli.py::cmd_jobtracker, ::cmd_tasktracker and ::_serve_forever),
and the side-input caches that such a long-lived runner keeps.

Oracle: the program's Lloyd rounds in float64, centroids within rtol 1e-5
and atol 1e-6 as in tests/test_torch_rounds.py. Every daemon is killed in
a finally and every wait has a timeout.
"""

import os
import select
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import torch

from tpumr_torch import cli
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.ops import kmeans, matmul
from tpumr_torch.ops.kmeans import clear_centroid_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
#: seconds any one wait may take here
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _fresh():
    FileSystem.clear_cache()
    clear_centroid_cache()
    yield
    FileSystem.clear_cache()
    clear_centroid_cache()
    matmul.clear_b_cache()


def _read_line(proc, timeout):
    """One line of the daemon's stderr, or fail after ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stderr], [], [], 0.2)
        if ready:
            return proc.stderr.readline().decode()
        assert proc.poll() is None, f"daemon exited {proc.returncode}"
    raise AssertionError("no line from the daemon")


def _lloyd(points, k, iters):
    """The program's rounds in float64: seeds are the first ``k`` rows, and
    a cluster without points keeps its centroid."""
    x = points.astype(np.float64)
    c = x[:k].copy()
    for _ in range(iters):
        ids = ((x[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)
        for j in range(k):
            if (ids == j).any():
                c[j] = x[ids == j].mean(0)
    return c


def _kmeans_twice(tmp_path, generic):
    """``examples kmeans`` run twice to one OUT, OUT removed in between,
    the second time over other points: the final centroids of each run.
    The second run rewrites the same centroid file with the same length,
    so a cache keyed by its path alone would serve the first run's."""
    out = tmp_path / ("remote" if generic else "local")
    got = []
    for name in ("points1.npy", "points2.npy"):
        shutil.rmtree(out, ignore_errors=True)
        assert cli.main([*generic, "examples", "kmeans",
                         f"file://{tmp_path}/{name}", f"file://{out}",
                         "-k", "4", "-i", "3", "--split-rows", "100",
                         "--cpu-only"]) == 0
        got.append(np.load(out / "centroids.npy"))
    return got


def test_daemons_serve_examples_and_stop_on_sigterm(tmp_path, capsys):
    """tpumr/cli.py::cmd_jobtracker and ::cmd_tasktracker in processes of
    their own: the master prints the port it took, a K-Means program sent
    there with -jt gives the float64 oracle's centroids, as it does run
    locally, also when it is run a second time to the same OUT over other
    points (the runner's centroid caches live in another process and must
    see the rewritten file), job -list shows its jobs, and both daemons
    exit 0 on SIGTERM. The local runs overlap the master's start."""
    rng = np.random.default_rng(1)
    points = [rng.normal(size=(600, 3)).astype(np.float32),
              rng.normal(loc=5.0, size=(600, 3)).astype(np.float32)]
    for i, pts in enumerate(points):
        np.save(tmp_path / f"points{i + 1}.npy", pts)
    want = [_lloyd(pts, 4, 3) for pts in points]
    py = [sys.executable, "-m", "tpumr_torch.cli"]
    procs = []
    try:
        jt = subprocess.Popen(py + ["jobtracker", "-port", "0"], cwd=REPO,
                              stderr=subprocess.PIPE)
        procs.append(jt)
        for g, w in zip(_kmeans_twice(tmp_path, []), want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        line = _read_line(jt, TIMEOUT)
        assert line.startswith("JobMaster up at 127.0.0.1:"), line
        addr = line.split()[-1]
        tt = subprocess.Popen(py + [
            "-jt", addr, "-D", "mapred.tasktracker.map.tpu.tasks.maximum=0",
            "-D", "mapred.tasktracker.map.cpu.tasks.maximum=2",
            "-D", "tpumr.heartbeat.interval.ms=20", "tasktracker"],
            cwd=REPO, stderr=subprocess.PIPE)
        procs.append(tt)
        assert "heartbeating to" in _read_line(tt, TIMEOUT)
        got = _kmeans_twice(tmp_path, ["-jt", addr])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        capsys.readouterr()
        assert cli.main(["-jt", addr, "job", "-list"]) == 0
        listed = capsys.readouterr().out
        states = [ln.split("\t")[1] for ln in listed.splitlines()]
        assert states == ["SUCCEEDED"] * 6
        for p in (tt, jt):
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=TIMEOUT) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=TIMEOUT)
            p.stderr.close()


@pytest.mark.parametrize("key,host,device", [
    ("tpumr.kmeans.centroids", kmeans._load_centroids,
     kmeans._device_centroids),
    ("tpumr.matmul.b", matmul._load_b, matmul._device_b),
], ids=["centroids", "matmul-b"])
def test_side_input_caches_see_a_rewritten_file(tmp_path, key, host, device):
    """The host and device caches of a side input (tpumr/ops/kmeans.py's
    _load_centroids, tpumr/ops/matmul.py's _load_b, both through
    tpumr/ops/devcache.py) key by path in the JAX package; the port's also
    check the file's length and mtime, so a file rewritten with the same
    shape is read anew without a clear, as a runner in another process
    needs."""
    path = tmp_path / "side.npy"
    conf = JobConf()
    conf.set(key, f"file://{path}")
    cpu = torch.device("cpu")
    for i, arr in enumerate(np.arange(24, dtype=np.float32).reshape(2, 4, 3)
                            * [[[1.0]], [[-1.0]]]):
        np.save(path, arr.astype(np.float32))
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + i * 10**9))
        np.testing.assert_array_equal(host(conf), arr)
        np.testing.assert_array_equal(device(conf, cpu).numpy(), arr)
