"""The port's blocked matmul job and its device-resident output chain
(tpumr_torch.ops.matmul, tpumr_torch.mapred.device_output,
DenseNpyOutputFormat, the map-only path of the local runner) against the
JAX package's (tpumr.ops.matmul, tpumr.mapred.device_output), on the CPU.

The port runs with tpumr_torch.device=cpu: with tpumr.local.run.on.tpu set,
its maps take the window path on CPU tensors, which is the card's path with
the products in torch on the CPU. f32 products agree to rtol 1e-4, the
tolerance of tests/test_ops.py::test_matmul_kernel (f32 sums of a few dozen
terms taken in another order). bf16 products (both operands rounded to
bfloat16, f32 accumulation and output) agree within 1e-5 of the f32 error
scale |A|.|B|: a product of two bf16 values is exact in f32, so only the
summation order differs.
"""

import glob
import hashlib
import os

import numpy as np
import pytest
import torch

from tpumr.core.counters import BackendCounter as JaxBackendCounter
from tpumr.mapred import device_output as jax_device_output
from tpumr.mapred.input_formats import DenseInputFormat as JaxDenseInputFormat
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr.mapred.output_formats import \
    DenseNpyOutputFormat as JaxDenseNpyOutputFormat
from tpumr.mapred.tpu_runner import clear_split_caches as jax_clear_splits
from tpumr.ops import matmul as jax_matmul
from tpumr_torch.core.counters import BackendCounter, JobCounter
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred import device_output, gpu_runner
from tpumr_torch.mapred.input_formats import DenseInputFormat
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job
from tpumr_torch.mapred.output_formats import DenseNpyOutputFormat
from tpumr_torch.ops import devcache, matmul, registry


@pytest.fixture(autouse=True)
def _fresh():
    gpu_runner.clear_split_caches()
    matmul.clear_b_cache()
    jax_clear_splits()
    jax_matmul.clear_b_cache()
    yield
    gpu_runner.clear_split_caches()
    matmul.clear_b_cache()


def _operands(m, k, n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16, as float64."""
    return torch.from_numpy(x).to(torch.bfloat16).double().numpy()


# ----------------------------------------------------------- block_matmul


@pytest.mark.parametrize("m,k,n", [(16, 8, 12), (64, 40, 24), (7, 129, 5)])
def test_block_matmul_f32_matches_jax(m, k, n):
    """Mirrors tests/test_ops.py::test_matmul_kernel: the f32 product
    against tpumr.ops.matmul._matmul_f32, rtol 1e-4."""
    a, b = _operands(m, k, n)
    got = matmul.block_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              bf16=False)
    want = np.asarray(jax_matmul._matmul_f32(a, b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("m,k,n", [(16, 8, 12), (64, 40, 24), (7, 129, 5)])
def test_block_matmul_bf16_matches_jax(m, k, n):
    """The bf16 product against tpumr.ops.matmul._matmul_bf16: f32 out,
    within 1e-5 of |A16|.|B16| of it and of the float64 product of the
    bf16-rounded operands, and not rounded to bf16 itself."""
    a, b = _operands(m, k, n)
    got = matmul.block_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    got = got.numpy()
    a16, b16 = _bf16(a), _bf16(b)
    scale = np.abs(a16) @ np.abs(b16)
    want = np.asarray(jax_matmul._matmul_bf16(a, b))
    assert want.dtype == np.float32
    assert np.all(np.abs(got - want) <= 1e-5 * scale)
    assert np.all(np.abs(got - a16 @ b16) <= 1e-5 * scale)
    # a bf16 result would round every entry to 8 bits of mantissa
    assert np.mean(_bf16(got) != got) > 0.5


def test_block_matmul_turns_tf32_off():
    """The f32 product never depends on another module having turned
    TF32 off first."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        a, b = _operands(8, 8, 8)
        matmul.block_matmul(torch.from_numpy(a), torch.from_numpy(b),
                            bf16=False)
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def test_kernel_and_cpu_mapper_match_jax(tmp_path):
    """MatmulBlockKernel (map_batch, map_batch_cpu) and MatmulCpuMapper
    against the JAX package's on one block (tests/test_ops.py:72-86)."""
    from tpumr.io.recordbatch import DenseBatch as JaxDenseBatch
    from tpumr.ops import get_kernel as jax_get_kernel
    from tpumr_torch.io.recordbatch import DenseBatch
    from tpumr_torch.mapred.api import OutputCollector, Reporter
    from tpumr_torch.ops import get_kernel
    a, b = _operands(16, 8, 12)
    np.save(tmp_path / "b.npy", b)
    confs = []
    for conf in (JobConf(), JaxJobConf()):
        conf.set("tpumr.matmul.b", f"file://{tmp_path}/b.npy")
        conf.set("tpumr.matmul.bf16", False)
        confs.append(conf)
    ids = np.arange(100, 116)
    kernel = get_kernel("matmul-block")
    [(row0, c)] = list(kernel.map_batch(
        DenseBatch(torch.from_numpy(a), ids), confs[0], None))
    [(jrow0, jc)] = list(jax_get_kernel("matmul-block").map_batch(
        JaxDenseBatch(a, ids), confs[1], None))
    assert row0 == jrow0 == 100
    np.testing.assert_allclose(c, jc, rtol=1e-4)
    [(row0, c)] = list(kernel.map_batch_cpu(DenseBatch(a, ids), confs[0],
                                            None))
    [(_, jc)] = list(jax_get_kernel("matmul-block").map_batch_cpu(
        JaxDenseBatch(a, ids), confs[1], None))
    assert row0 == 100
    np.testing.assert_array_equal(c, jc)
    got, want = [], []
    for mapper, out in ((matmul.MatmulCpuMapper(), got),
                        (jax_matmul.MatmulCpuMapper(), want)):
        mapper.configure(confs[0] if out is got else confs[1])
        mapper.map(3, a[3], OutputCollector(lambda k, v, o=out:
                                            o.append((k, v))), Reporter())
    assert got[0][0] == want[0][0] == 3
    np.testing.assert_array_equal(got[0][1], want[0][1])


def test_fetch_to_host_keeps_dicts_and_ints():
    """matmul's state {"c": tensor, "row0": int} beside K-Means' tuples,
    still in one copy."""
    states = [{"c": torch.arange(6, dtype=torch.float32).reshape(2, 3),
               "row0": 7},
              (torch.tensor([1, 2], dtype=torch.int32),
               torch.tensor([0.5], dtype=torch.float64))]
    out = registry.fetch_to_host(states)
    assert out[0]["row0"] == 7
    np.testing.assert_array_equal(out[0]["c"], states[0]["c"].numpy())
    assert isinstance(out[1], tuple) and out[1][0].dtype == np.int32
    np.testing.assert_array_equal(out[1][1], [0.5])


# ----------------------------------------------------------- the jobs


def _job_conf(conf, inp, out, work, rows, bf16=False, on_device=True,
              **keys):
    conf.set_input_paths(inp)
    conf.set_output_path(out)
    conf.set("tpumr.dense.split.rows", rows)
    conf.set("tpumr.matmul.b", f"file://{work}/b.npy")
    conf.set("tpumr.matmul.bf16", bf16)
    conf.set_map_kernel("matmul-block")
    conf.set_num_reduce_tasks(0)
    if on_device:
        conf.set("tpumr.local.run.on.tpu", True)
    for k, v in keys.items():
        conf.set(k, v)
    return conf


def _port(inp, out, work, rows, **kw):
    conf = _job_conf(JobConf(), inp, out, work, rows, **kw)
    conf.set_input_format(DenseInputFormat)
    conf.set_output_format(DenseNpyOutputFormat)
    conf.set("tpumr_torch.device", "cpu")
    res = run_job(conf)
    assert res.successful
    return res


def _jax(inp, out, work, rows, **kw):
    conf = _job_conf(JaxJobConf(), inp, out, work, rows, **kw)
    conf.set_input_format(JaxDenseInputFormat)
    conf.set_output_format(JaxDenseNpyOutputFormat)
    res = jax_run_job(conf)
    assert res.successful
    return res


def _parts(out_dir):
    return sorted(glob.glob(f"{out_dir}/part-*.npy"))


def _write(work, n, d, seed=7):
    """tests/test_device_output.py::_write_chain_input."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(d, d)).astype(np.float32)
    np.save(f"{work}/a.npy", a)
    np.save(f"{work}/b.npy", b)
    return a, b


@pytest.mark.parametrize("bf16,on_device", [(False, True), (True, True),
                                            (False, False)])
def test_matmul_job_matches_jax_job(tmp_path, bf16, on_device):
    """The map-only job through both packages: one part file per map, each
    equal to the JAX package's within tolerance (bit-equal on the CPU
    batch path, where both run the same numpy product)."""
    work = str(tmp_path)
    a, b = _write(work, 64, 16)
    res = _port(f"file://{work}/a.npy", f"file://{work}/c", work, 16,
                bf16=bf16, on_device=on_device)
    jres = _jax(f"file://{work}/a.npy", f"file://{work}/cj", work, 16,
                bf16=bf16, on_device=on_device)
    got, want = _parts(f"{work}/c"), _parts(f"{work}/cj")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        [f"part-{i:05d}.npy" for i in range(4)]
    assert os.path.exists(f"{work}/c/_SUCCESS")
    assert not os.path.exists(f"{work}/c/_temporary")
    a16, b16 = (_bf16(a), _bf16(b)) if bf16 else (a, b)
    scale = np.abs(a16) @ np.abs(b16)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.load(g), np.load(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == (16, 16)
        if not on_device:
            np.testing.assert_array_equal(g, w)
        elif bf16:
            assert np.all(np.abs(g - w) <= 1e-5 * scale[16 * i:16 * i + 16])
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    assert res.num_maps == 4 and res.num_reduces == 0
    tasks = BackendCounter.TPU_MAP_TASKS if on_device \
        else BackendCounter.CPU_MAP_TASKS
    assert res.counters.value(BackendCounter.GROUP, tasks) == 4
    assert res.counters.value(JobCounter.GROUP,
                              JobCounter.LAUNCHED_REDUCE_TASKS) == 0
    assert res.counters.value(BackendCounter.GROUP,
                              BackendCounter.TPU_DEVICE_BYTES_STAGED) == \
        jres.counters.value(JaxBackendCounter.GROUP,
                            JaxBackendCounter.TPU_DEVICE_BYTES_STAGED)


@pytest.mark.parametrize("keys", [{}, {"tpumr.tpu.pipeline.window": 0}])
def test_chain_second_job_stages_zero_bytes(tmp_path, keys):
    """Mirrors tests/test_device_output.py::TestChainEndToEnd::
    test_matmul_chain_consumes_resident_output: job 1 writes C = A @ B;
    job 2 computes D = C @ B over job 1's output directory, stages 0 bytes
    (C is still resident), and is right; the JAX chain gives the same D.
    With tpumr.tpu.pipeline.window=0 every map takes the per-task path."""
    work = str(tmp_path)
    a, b = _write(work, 64, 16)
    r1 = _port(f"file://{work}/a.npy", f"file://{work}/c", work, 16, **keys)
    assert r1.counters.value(BackendCounter.GROUP,
                             BackendCounter.TPU_DEVICE_BYTES_STAGED) > 0
    hits = []
    real = device_output.lookup

    def counted(*args):
        got = real(*args)
        hits.append(got is not None)
        return got

    device_output.lookup = counted
    try:
        r2 = _port(f"file://{work}/c", f"file://{work}/d", work, 16, **keys)
    finally:
        device_output.lookup = real
    assert r2.counters.value(BackendCounter.GROUP,
                             BackendCounter.TPU_DEVICE_BYTES_STAGED) == 0
    assert hits == [True] * 4
    d_got = np.concatenate([np.load(p) for p in _parts(f"{work}/d")])
    np.testing.assert_allclose(d_got, (a @ b) @ b, rtol=2e-4)
    _jax(f"file://{work}/a.npy", f"file://{work}/cj", work, 16)
    j2 = _jax(f"file://{work}/cj", f"file://{work}/dj", work, 16)
    assert j2.counters.value(JaxBackendCounter.GROUP,
                             JaxBackendCounter.TPU_DEVICE_BYTES_STAGED) == 0
    d_jax = np.concatenate([np.load(p) for p in _parts(f"{work}/dj")])
    np.testing.assert_allclose(d_got, d_jax, rtol=1e-4, atol=1e-4)


def test_chain_survives_cache_eviction(tmp_path):
    """Mirrors tests/test_device_output.py::TestChainEndToEnd::
    test_chain_survives_cache_eviction: with tpumr.tpu.split.cache.mb=0
    nothing stays resident, job 2 reads the files, and D is still right."""
    work = str(tmp_path)
    a, b = _write(work, 32, 8)
    keys = {"tpumr.tpu.split.cache.mb": 0}
    _port(f"file://{work}/a.npy", f"file://{work}/c", work, 16, **keys)
    gpu_runner.clear_split_caches()
    r2 = _port(f"file://{work}/c", f"file://{work}/d", work, 16, **keys)
    assert r2.counters.value(BackendCounter.GROUP,
                             BackendCounter.TPU_DEVICE_BYTES_STAGED) == \
        32 * 8 * 4
    d_got = np.concatenate([np.load(p) for p in _parts(f"{work}/d")])
    np.testing.assert_allclose(d_got, (a @ b) @ b, rtol=2e-4)


def test_failed_map_attempt_writes_and_publishes_nothing(tmp_path,
                                                         monkeypatch):
    """A map-only attempt that raises aborts its dense writer: no part
    file in its work dir, and its offered rows are claimed, not
    published."""
    work = str(tmp_path)
    _write(work, 32, 8)
    calls = []

    def boom(self, fetched, conf, task):
        calls.append(str(conf.get("tpumr.task.attempt.id")))
        raise RuntimeError("drain failed")

    monkeypatch.setattr(matmul.MatmulBlockKernel, "map_batch_drain", boom)
    published = []
    monkeypatch.setattr(device_output, "publish",
                        lambda *a, **k: published.append(a))
    with pytest.raises(RuntimeError, match="drain failed"):
        _port(f"file://{work}/a.npy", f"file://{work}/c", work, 16)
    assert calls and published == []
    assert glob.glob(f"{work}/c/**/*.npy", recursive=True) == []
    assert device_output.claim(calls[0]) is None


# ----------------------------------------------------------- device_output


def test_head_tail_mirrors_lookup_reads(tmp_path):
    """Mirrors tests/test_device_output.py::TestFingerprint."""
    data = bytes(range(256)) * 64          # 16 KB
    p = tmp_path / "f.bin"
    p.write_bytes(data)
    head, tail, size = device_output.head_tail(data)
    with open(p, "rb") as f:
        rhead = f.read(4096)
        f.seek(max(4096, size - 4096))
        rtail = f.read(4096)
    assert (rhead, rtail, p.stat().st_size) == (head, tail, size)
    assert device_output.head_tail(data) == jax_device_output.head_tail(data)
    assert device_output.head_tail(b"abc") == (b"abc", b"", 3)
    assert device_output.fingerprint(head, tail, size, 1.5) == \
        jax_device_output.fingerprint(head, tail, size, 1.5)


def test_boundary_alias_never_serves_wrong_rows(tmp_path):
    """Mirrors tests/test_device_output.py::TestAliasRejection: two files
    of the same size, mtime and 4 KB ends but another middle; only the
    published one is served."""
    conf = JobConf()
    fs = FileSystem.get(f"file://{tmp_path}")
    real = bytearray(os.urandom(32 * 1024))
    alias = bytearray(real)
    alias[16_000:16_016] = b"DIFFERENTPAYLOAD"
    pr, pa = tmp_path / "real.bin", tmp_path / "alias.bin"
    pr.write_bytes(real)
    pa.write_bytes(alias)
    mtime = pr.stat().st_mtime
    os.utime(pa, (mtime, mtime))
    rows = torch.arange(8.0).reshape(2, 4)
    head, tail, size = device_output.head_tail(bytes(real))
    device_output.publish(conf, rows, head, tail, size, mtime,
                          full_sha=hashlib.sha1(bytes(real)).hexdigest())
    ha, ta, sa = device_output.head_tail(bytes(alias))
    assert device_output.fingerprint(ha, ta, sa, mtime) == \
        device_output.fingerprint(head, tail, size, mtime)
    dev = torch.device("cpu")
    assert device_output.lookup(conf, dev, fs, f"file://{pa}", size,
                                mtime) is None
    got = device_output.lookup(conf, dev, fs, f"file://{pr}", size, mtime)
    assert got is rows


def test_publish_takes_a_tensor_only():
    """The JAX package's publish returns quietly on an array without
    devices(); the port raises, so a host array never looks published."""
    with pytest.raises(TypeError, match="torch.Tensor"):
        device_output.publish(JobConf(), np.zeros((2, 2), np.float32),
                              b"", b"", 0, 0.0)


def test_numpy_dtype_compares_across_packages():
    assert device_output.numpy_dtype(torch.float32) == np.dtype("<f4")
    assert str(torch.float32) != str(np.dtype(np.float32))
    assert device_output.numpy_dtype(torch.bfloat16) is None


def test_offer_claim_roundtrip_and_cap():
    """Mirrors tests/test_device_output.py::TestOfferClaim."""
    t = torch.zeros(1)
    device_output.offer("a1", t)
    assert device_output.claim("a1") is t
    assert device_output.claim("a1") is None
    for i in range(40):
        device_output.offer(f"x{i}", torch.tensor([i]))
    assert device_output.claim("x0") is None
    assert int(device_output.claim("x39")) == 39


# ----------------------------------------------------------- devcache


def test_devcache_inventory_and_occupancy(monkeypatch):
    """Mirrors tests/test_feedback_scheduling.py::TestDevcacheInventory."""
    cache = gpu_runner.DeviceSplitCache(1 << 20)
    cache.put(("kmeans-centroids:file:///c", "cuda:0"), object(), 100)
    cache.put(("kmeans-centroids:file:///c", "cuda:1"), object(), 100)
    cache.put(("matmul-b:file:///b", "cuda:0"), object(), 5000)
    monkeypatch.setattr(devcache, "_cache", cache)
    assert devcache.inventory() == {"kmeans-centroids:file:///c": 200,
                                    "matmul-b:file:///b": 5000}
    assert list(devcache.inventory(max_tags=1)) == ["matmul-b:file:///b"]
    occ = devcache.occupancy()
    assert occ["entries"] == 3 and occ["bytes"] == 5200
    assert occ["families"] == {"kmeans-centroids": 200, "matmul-b": 5000}
    monkeypatch.setattr(devcache, "_cache", None)
    assert devcache.inventory() == {}
    assert devcache.occupancy() == {"entries": 0, "bytes": 0,
                                    "families": {}}


def test_b_uploaded_once_per_device_and_cleared(tmp_path):
    """B rides the device cache under matmul-b:<path>; clear_b_cache
    drops it."""
    _write(str(tmp_path), 8, 4)
    conf = JobConf()
    conf.set("tpumr.matmul.b", f"file://{tmp_path}/b.npy")
    first = matmul._device_b(conf, torch.device("cpu"))
    assert matmul._device_b(conf, torch.device("cpu")) is first
    assert f"matmul-b:file://{tmp_path}/b.npy" in devcache.inventory()
    matmul.clear_b_cache()
    assert not any(t.startswith("matmul-b:") for t in devcache.inventory())
