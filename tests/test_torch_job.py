"""The port's whole K-Means job (tpumr_torch.mapred.local_runner) against the
same job through the JAX package (tpumr.mapred.local_runner.run_job with
tpumr.local.run.on.tpu on JAX's CPU backend), on the same file:// inputs.

The port runs on the CPU here (tpumr_torch.device=cpu or device="cpu"):
its kernel wrapper then takes its plain torch version. Centroids agree to
rtol 1e-5 and atol 1e-6: every map task's f32 partial sums are taken in
another summation order by the two packages, then averaged in float64.
"""

import ast

import numpy as np
import pytest
import torch

from tpumr.core.counters import BackendCounter as JaxBackendCounter
from tpumr.mapred.input_formats import DenseInputFormat as JaxDenseInputFormat
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr.mapred.tpu_runner import clear_split_caches as jax_clear_splits
from tpumr.ops.kmeans import clear_centroid_cache as jax_clear_centroids
from tpumr_torch.core.counters import BackendCounter, JobCounter, TaskCounter
from tpumr_torch.mapred import gpu_runner
from tpumr_torch.mapred.input_formats import DenseInputFormat
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred import local_runner
from tpumr_torch.mapred.local_runner import maps_on_device, run_job
from tpumr_torch.ops import registry
from tpumr_torch.ops.kmeans import CentroidReducer, clear_centroid_cache


def _blobs():
    """The 3-blob 150x2 case of tests/test_tpu_runner.py:34-80."""
    rng = np.random.default_rng(42)
    pts = np.concatenate([rng.normal(loc=c, scale=0.1, size=(50, 2))
                          for c in [(0, 0), (5, 5), (-5, 5)]]
                         ).astype(np.float32)
    rng.shuffle(pts)
    return pts, np.array([[0.5, 0.5], [4, 4], [-4, 4]], np.float32), 40


def _wide():
    """2,000 x 16 points, k = 16, 5 splits."""
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2000, 16), dtype=np.float32),
            rng.standard_normal((16, 16), dtype=np.float32), 400)


def _over_cap():
    """600 x 130 points, k = 130, 3 splits: k * d = 16,900, over the
    k * d <= 16,384 cap kmeans_assign once had on the card."""
    rng = np.random.default_rng(6)
    return (rng.standard_normal((600, 130), dtype=np.float32),
            rng.standard_normal((130, 130), dtype=np.float32), 200)


def _write_inputs(tmp_path, pts, cents):
    np.save(tmp_path / "points.npy", pts)
    np.save(tmp_path / "cents.npy", cents)


def _conf(conf, tmp_path, out, rows, on_device=True):
    conf.set_input_paths(f"file://{tmp_path}/points.npy")
    conf.set_output_path(f"file://{tmp_path}/{out}")
    conf.set("tpumr.dense.split.rows", rows)
    conf.set("tpumr.kmeans.centroids", f"file://{tmp_path}/cents.npy")
    conf.set_map_kernel("kmeans-assign")
    conf.set_num_reduce_tasks(1)
    if on_device is not None:
        conf.set("tpumr.local.run.on.tpu", on_device)
    return conf


def _jax_job(tmp_path, rows, on_device=True, **keys):
    jax_clear_centroids()
    jax_clear_splits()
    conf = _conf(JaxJobConf(), tmp_path, "out-jax", rows, on_device)
    conf.set_input_format(JaxDenseInputFormat)
    conf.set("mapred.reducer.class", "tpumr.examples.basic.CentroidReducer")
    for k, v in keys.items():
        conf.set(k, v)
    result = jax_run_job(conf)
    assert result.successful
    return result, _centroids(tmp_path / "out-jax")


def _port_conf(tmp_path, out, rows, on_device=True, **keys):
    conf = _conf(JobConf(), tmp_path, out, rows, on_device)
    conf.set_input_format(DenseInputFormat)
    conf.set_reducer_class(CentroidReducer)
    for k, v in keys.items():
        conf.set(k, v)
    return conf


def _port_job(tmp_path, rows, out="out-port", device=None, on_device=True,
              **keys):
    clear_centroid_cache()
    gpu_runner.clear_split_caches()
    conf = _port_conf(tmp_path, out, rows, on_device, **keys)
    if device is None:
        conf.set("tpumr_torch.device", "cpu")
    result = run_job(conf, device=device)
    assert result.successful
    return result, _centroids(tmp_path / out)


def _centroids(out_dir):
    got = {}
    for line in (out_dir / "part-00000").read_text().splitlines():
        k, v = line.split("\t")
        got[int(k)] = np.array(ast.literal_eval(v))
    assert (out_dir / "_SUCCESS").exists()
    return got


#: counters both packages count the same way on this job
_SAME = [(TaskCounter.FRAMEWORK_GROUP, n) for n in (
    TaskCounter.MAP_INPUT_RECORDS, TaskCounter.MAP_OUTPUT_RECORDS,
    TaskCounter.MAP_OUTPUT_BYTES, TaskCounter.SPILLED_RECORDS,
    TaskCounter.REDUCE_INPUT_GROUPS, TaskCounter.REDUCE_INPUT_RECORDS,
    TaskCounter.REDUCE_OUTPUT_RECORDS)] + [
    (BackendCounter.GROUP, n) for n in (
        BackendCounter.TPU_MAP_TASKS, BackendCounter.CPU_MAP_TASKS,
        BackendCounter.TPU_DEVICE_BYTES_STAGED,
        BackendCounter.CPU_BATCH_MAP_TASKS)] + [
    (JobCounter.GROUP, n) for n in (JobCounter.LAUNCHED_MAP_TASKS,
                                    JobCounter.LAUNCHED_REDUCE_TASKS)]


@pytest.mark.parametrize("case,device,keys", [
    ("blobs", "cpu", {}),
    ("wide", None, {}),
    ("wide", None, {"tpumr.tpu.pipeline.window": 2}),
    ("wide", None, {"tpumr.tpu.pipeline.window": 0}),   # per-task path
    ("over_cap", "cpu", {}),
])
def test_kmeans_job_matches_jax_job(tmp_path, case, device, keys):
    pts, cents, rows = {"blobs": _blobs, "wide": _wide,
                        "over_cap": _over_cap}[case]()
    _write_inputs(tmp_path, pts, cents)
    jres, want = _jax_job(tmp_path, rows, **keys)
    res, got = _port_job(tmp_path, rows, device=device, **keys)

    assert sorted(got) == sorted(want)
    for cid in want:
        np.testing.assert_allclose(got[cid], want[cid], rtol=1e-5, atol=1e-6)
    n = pts.shape[0]
    assert res.num_maps == jres.num_maps == -(-n // rows)
    assert res.counters.value(BackendCounter.GROUP,
                              BackendCounter.TPU_MAP_TASKS) == res.num_maps
    assert res.counters.value(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.MAP_INPUT_RECORDS) == n
    for group, name in _SAME:
        assert res.counters.value(group, name) == \
            jres.counters.value(group, name), name


def test_cpu_batch_job_matches_jax_exactly(tmp_path):
    """With tpumr.local.run.on.tpu off both packages run CPU-slot batch maps
    through the same numpy code (map_batch_cpu): the committed centroids
    are equal."""
    pts, cents, rows = _wide()
    _write_inputs(tmp_path, pts, cents)
    jres, want = _jax_job(tmp_path, rows, on_device=False)
    res, got = _port_job(tmp_path, rows, on_device=False)
    assert sorted(got) == sorted(want)
    for cid in want:
        np.testing.assert_array_equal(got[cid], want[cid])
    assert res.counters.value(BackendCounter.GROUP,
                              BackendCounter.CPU_BATCH_MAP_TASKS) == 5
    assert jres.counters.value(JaxBackendCounter.GROUP,
                               JaxBackendCounter.CPU_BATCH_MAP_TASKS) == 5


def test_port_raises_without_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """The port runs on cuda by default and never falls back to the CPU
    in silence."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, cents, rows = _blobs()
    _write_inputs(tmp_path, pts, cents)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_job(_port_conf(tmp_path, "out-a", rows))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_job(_port_conf(tmp_path, "out-b", rows), device="cuda")
    assert run_job(_port_conf(tmp_path, "out-c", rows),
                   device="cpu").successful


@pytest.mark.parametrize("device,key,kernel,want", [
    ("cuda", None, True, True),      # the card: the key is not needed
    ("cuda", False, True, True),     # nor can it send maps to the host
    ("cuda:0", None, True, True),
    ("cpu", None, True, False),      # CPU: numpy batch runner
    ("cpu", True, True, True),       # CPU: windows on CPU tensors
    ("cuda", None, False, False),    # no kernel mapper named
])
def test_maps_on_device_follows_the_device(device, key, kernel, want):
    """The device decides where a kernel mapper's tasks run; on cuda they
    never go to the host batch runner."""
    conf = JobConf()
    if kernel:
        conf.set_map_kernel("kmeans-assign")
    if key is not None:
        conf.set("tpumr.local.run.on.tpu", key)
    assert maps_on_device(conf, torch.device(device)) is want


def test_run_job_on_cuda_needs_no_run_on_tpu_key(tmp_path, monkeypatch):
    """run_job routes by the device it selected: with cuda selected and
    tpumr.local.run.on.tpu unset, every map takes the device path and none
    the CPU batch runner. The tasks compute on the CPU here
    (tpumr_torch.device=cpu); only the job's routing sees cuda."""
    monkeypatch.setattr(local_runner, "select_device",
                        lambda conf: torch.device("cuda", 0))
    pts, cents, rows = _wide()
    _write_inputs(tmp_path, pts, cents)
    conf = _port_conf(tmp_path, "out-port", rows, on_device=None)
    conf.set("tpumr_torch.device", "cpu")
    clear_centroid_cache()
    gpu_runner.clear_split_caches()
    res = run_job(conf)
    _jres, want = _jax_job(tmp_path, rows)
    got = _centroids(tmp_path / "out-port")
    assert res.counters.value(BackendCounter.GROUP,
                              BackendCounter.TPU_MAP_TASKS) == 5
    for name in (BackendCounter.CPU_BATCH_MAP_TASKS,
                 BackendCounter.CPU_MAP_TASKS):
        assert res.counters.value(BackendCounter.GROUP, name) == 0, name
    assert sorted(got) == sorted(want)
    for cid in want:
        np.testing.assert_allclose(got[cid], want[cid], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("keys,fetches", [
    ({}, 1),                                          # one window
    ({"tpumr.tpu.pipeline.window": 2}, 2),            # ceil(4 / 2)
    ({"tpumr.tpu.pipeline.window.mb": 0,              # every task closes
      "tpumr.tpu.split.cache": False}, 4),            # its window
])
def test_window_fetches_once_per_window(tmp_path, monkeypatch, keys, fetches):
    """Mirrors tests/test_tpu_runner.py:154-202: one device-to-host copy
    per window, and the byte budget closes a window early."""
    calls = []
    real = registry.fetch_to_host
    monkeypatch.setattr(registry, "fetch_to_host",
                        lambda states: (calls.append(len(states)),
                                        real(states))[1])
    pts, cents, rows = _blobs()      # 4 splits
    _write_inputs(tmp_path, pts, cents)
    res, _ = _port_job(tmp_path, rows, **keys)
    assert res.num_maps == 4
    assert len(calls) == fetches and sum(calls) == 4


def test_split_cache_hit_on_second_round_and_identical_output(tmp_path):
    """Mirrors tests/test_tpu_runner.py:284-318: round 2 stages nothing new
    (the device split cache holds every split) and commits byte-identical
    output (no float atomics anywhere on the path)."""
    clear_centroid_cache()
    gpu_runner.clear_split_caches()
    pts, cents, rows = _wide()
    _write_inputs(tmp_path, pts, cents)
    outs = []
    for i in range(2):
        conf = _port_conf(tmp_path, f"out{i}", rows)
        res = run_job(conf, device="cpu")
        staged = res.counters.value(BackendCounter.GROUP,
                                    BackendCounter.TPU_DEVICE_BYTES_STAGED)
        assert staged == (pts.nbytes if i == 0 else 0)
        outs.append((tmp_path / f"out{i}" / "part-00000").read_bytes())
    assert outs[0] == outs[1]
    assert any(c.hits >= 5 for c in gpu_runner._split_caches.values())
    gpu_runner.clear_split_caches()


def test_device_split_cache_is_lru_by_bytes():
    cache = gpu_runner.DeviceSplitCache(100)
    cache.put(("a",), "A", 60)
    cache.put(("b",), "B", 30)
    assert cache.get(("a",)) == "A"       # a is now most recent
    cache.put(("c",), "C", 40)            # evicts b, the least recent
    assert cache.get(("b",)) is None
    assert cache.get(("c",)) == "C" and cache.resident_bytes == 100
    cache.put(("d",), "D", 101)           # oversized: never evicts
    assert cache.get(("d",)) is None and cache.resident_bytes == 100
    assert (cache.hits, cache.misses) == (2, 2)


def test_fetch_to_host_one_copy_keeps_dtypes_and_shapes():
    states = [(torch.arange(6, dtype=torch.float32).reshape(2, 3),
               torch.tensor([7, 8], dtype=torch.int32)),
              (torch.tensor([1.5], dtype=torch.float64),)]
    out = registry.fetch_to_host(states)
    assert [len(s) for s in out] == [2, 1]
    for got_state, want_state in zip(out, states):
        for got, want in zip(got_state, want_state):
            assert got.dtype == want.numpy().dtype
            np.testing.assert_array_equal(got, want.numpy())
