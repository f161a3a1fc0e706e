"""Iterative K-Means rounds through the port (expand_round,
KMeansCentroidUpdateReducer, run_job; the examples kmeans program) against
the same rounds through the JAX package, on the CPU.

The port runs with device="cpu" and tpumr.local.run.on.tpu set: its maps
take the window path on CPU tensors, the card's path with the kernel's
plain version. Round files agree to rtol 1e-5, atol 1e-6 (as
tests/test_torch_job.py: every map's f32 partial sums are taken in another
order by the two packages, then averaged in float64), and the shift counter
to 1 milli (it is rounded from sums of those centroids).
Also pinned here: the attempt's localised conf keys and the abort seam of
a failed reduce attempt, two faults the port had against the reference.
"""

import io
import os
import re

import numpy as np
import pytest

import tpumr.examples as jax_examples
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr.mapred.tpu_runner import clear_split_caches as jax_clear_splits
from tpumr.ops import kmeans as jax_kmeans
from tpumr.ops.registry import register_kernel as jax_register_kernel
from tpumr.pipeline.graph import expand_round as jax_expand_round
from tpumr_torch import cli, examples
from tpumr_torch.mapred import gpu_runner
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job
from tpumr_torch.ops import devcache
from tpumr_torch.ops import kmeans
from tpumr_torch.ops.registry import register_kernel
from tpumr_torch.pipeline.graph import expand_round

ROUNDS = 3


@pytest.fixture(autouse=True)
def _fresh():
    kmeans.clear_pipeline_caches()
    gpu_runner.clear_split_caches()
    jax_kmeans.clear_pipeline_caches()
    jax_clear_splits()
    yield
    kmeans.clear_pipeline_caches()
    gpu_runner.clear_split_caches()


def _blobs():
    """The 3-blob 150x2 case of tests/test_torch_job.py."""
    rng = np.random.default_rng(42)
    pts = np.concatenate([rng.normal(loc=c, scale=0.1, size=(50, 2))
                          for c in [(0, 0), (5, 5), (-5, 5)]]
                         ).astype(np.float32)
    rng.shuffle(pts)
    return pts, np.array([[0.5, 0.5], [4, 4], [-4, 4]], np.float32), 40


def _wide():
    """The 2,000 x 16, k = 16, 5-split case of tests/test_torch_job.py."""
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2000, 16), dtype=np.float32),
            rng.standard_normal((16, 16), dtype=np.float32), 400)


def _round_conf(work, tag, rows, reducer):
    """bench.py's round conf (bench.py:290-305) on the local runner, with
    the kernel mapper named: versioned centroid paths in and out."""
    return {
        "mapred.input.dir": f"file://{work}/points.npy",
        "mapred.output.dir": f"file://{work}/{tag}-out-r{{round}}",
        "tpumr.dense.split.rows": rows,
        "mapred.reducer.class": reducer,
        "mapred.reduce.tasks": 1,
        "tpumr.kmeans.centroids": f"file://{work}/{tag}-cents-r{{round}}.npy",
        "tpumr.kmeans.centroids.out":
            f"file://{work}/{tag}-cents-r{{next_round}}.npy",
        "tpumr.map.kernel": "kmeans-assign",
        "tpumr.local.run.on.tpu": True,
    }


def _port_round(work, tag, rows, r,
                reducer="tpumr_torch.ops.kmeans.KMeansCentroidUpdateReducer"):
    """Round r through the port: (result, map-side centroid uploads)."""
    conf = JobConf()
    conf.set("mapred.input.format.class",
             "tpumr_torch.mapred.input_formats.DenseInputFormat")
    for k, v in expand_round(_round_conf(work, tag, rows, reducer),
                             r).items():
        conf.set(k, v)
    before = kmeans.centroids_from_numpy.uploads
    res = run_job(conf, device="cpu")
    assert res.successful
    return res, kmeans.centroids_from_numpy.uploads - before


def _port_rounds(work, tag, rows, clear_each_round=False, rounds=ROUNDS,
                 **kw):
    out = []
    for r in range(rounds):
        if clear_each_round:
            kmeans.clear_centroid_cache()
        out.append(_port_round(work, tag, rows, r, **kw))
    return out


def _jax_rounds(work, tag, rows, rounds=ROUNDS):
    out = []
    for r in range(rounds):
        conf = JaxJobConf()
        conf.set("mapred.input.format.class",
                 "tpumr.mapred.input_formats.DenseInputFormat")
        for k, v in jax_expand_round(_round_conf(
                work, tag, rows,
                "tpumr.ops.kmeans.KMeansCentroidUpdateReducer"), r).items():
            conf.set(k, v)
        res = jax_run_job(conf)
        assert res.successful
        out.append(res)
    return out


def _shift(res):
    return res.counters.value(kmeans.SHIFT_COUNTER_GROUP,
                              kmeans.SHIFT_COUNTER)


@pytest.mark.parametrize("case", ["blobs", "wide"])
def test_rounds_match_jax_rounds(tmp_path, case):
    """Three rounds of the port against three rounds of
    tpumr.mapred.local_runner.run_job with
    tpumr.ops.kmeans.KMeansCentroidUpdateReducer (bench.py:320-336 without
    the cluster): every round's .npy, and the shift counter, which is
    round(1000 * sum|r_next - r|) of the two files."""
    pts, cents, rows = {"blobs": _blobs, "wide": _wide}[case]()
    np.save(tmp_path / "points.npy", pts)
    for tag in ("port", "jax"):
        np.save(tmp_path / f"{tag}-cents-r0.npy", cents)
    port = _port_rounds(tmp_path, "port", rows)
    jax = _jax_rounds(tmp_path, "jax", rows)
    for r in range(ROUNDS):
        got = np.load(tmp_path / f"port-cents-r{r + 1}.npy")
        want = np.load(tmp_path / f"jax-cents-r{r + 1}.npy")
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        prev = np.load(tmp_path / f"port-cents-r{r}.npy")
        assert _shift(port[r][0]) == int(round(
            float(np.abs(got - prev).sum()) * 1000))
        assert abs(_shift(port[r][0]) - _shift(jax[r])) <= 1
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_versioned_rounds_equal_clear_per_round_and_preseed_hits(tmp_path):
    """bench.py:379-381: versioned rounds (no clear between rounds) give
    byte-identical centroid files to rounds that clear the centroid caches
    before each round. Versioned rounds upload their centroids in round 0
    only: from round 1 on the update reducer's pre-seed serves the maps,
    and the next round's tag is resident after each round."""
    pts, cents, rows = _wide()
    np.save(tmp_path / "points.npy", pts)
    np.save(tmp_path / "v-cents-r0.npy", cents)
    np.save(tmp_path / "s-cents-r0.npy", cents)
    preseeds0 = kmeans.KMeansCentroidUpdateReducer.preseeds
    versioned = []
    for r in range(ROUNDS):
        versioned.append(_port_round(tmp_path, "v", rows, r)[1])
        assert f"kmeans-centroids:file://{tmp_path}/v-cents-r{r + 1}.npy" \
            in devcache.inventory()
    assert versioned == [1] + [0] * (ROUNDS - 1)
    assert kmeans.KMeansCentroidUpdateReducer.preseeds - preseeds0 == ROUNDS
    seq = _port_rounds(tmp_path, "s", rows, clear_each_round=True)
    assert [u for _res, u in seq] == [1] * ROUNDS
    for r in range(1, ROUNDS + 1):
        assert (tmp_path / f"v-cents-r{r}.npy").read_bytes() == \
            (tmp_path / f"s-cents-r{r}.npy").read_bytes()
    kmeans.clear_pipeline_caches()
    assert not any(t.startswith("kmeans-centroids:")
                   for t in devcache.inventory())


class FailingUpdateReducer(kmeans.KMeansCentroidUpdateReducer):
    """Raises in its second group, after one cluster was fed."""

    calls: list = []

    def reduce(self, key, values, output, reporter):
        if self._sums:
            raise RuntimeError("reduce failed mid-way")
        super().reduce(key, values, output, reporter)

    def abort(self):
        FailingUpdateReducer.calls.append("abort")
        super().abort()

    def close(self):
        FailingUpdateReducer.calls.append("close")
        super().close()


def test_failed_update_reduce_aborts_and_publishes_nothing(tmp_path):
    """Mirrors tpumr/ops/kmeans.py::KMeansCentroidUpdateReducer.abort and
    tpumr/mapred/reduce_task.py:183-199: a reduce attempt that raises
    mid-way goes through abort(), not close(), so no next-round file is
    written and nothing is pre-seeded."""
    pts, cents, rows = _blobs()
    np.save(tmp_path / "points.npy", pts)
    np.save(tmp_path / "f-cents-r0.npy", cents)
    FailingUpdateReducer.calls = []
    with pytest.raises(RuntimeError, match="reduce failed mid-way"):
        _port_round(tmp_path, "f", rows, 0,
                    reducer=f"{__name__}.FailingUpdateReducer")
    assert FailingUpdateReducer.calls == ["abort"]
    assert not (tmp_path / "f-cents-r1.npy").exists()
    assert [f for f in os.listdir(tmp_path) if f.startswith("f-cents")] == \
        ["f-cents-r0.npy"]
    assert f"kmeans-centroids:file://{tmp_path}/f-cents-r1.npy" \
        not in devcache.inventory()


class RecordingReducer:
    """A reducer with both seams that records which one ran; raises on its
    first group when ``fail`` is set."""

    calls: list = []
    fail = True

    def configure(self, conf):
        pass

    def reduce(self, key, values, output, reporter):
        if RecordingReducer.fail:
            raise RuntimeError("boom")
        output.collect(key, 1)

    def abort(self):
        RecordingReducer.calls.append("abort")

    def close(self):
        RecordingReducer.calls.append("close")


@pytest.mark.parametrize("fail,want", [(True, ["abort"]), (False, ["close"])])
def test_reduce_attempt_closes_or_aborts_as_the_reference(tmp_path, fail,
                                                          want):
    """tpumr/mapred/reduce_task.py:183-199: close() after a good attempt,
    abort() (where the reducer has one) after a failed one, in both
    packages."""
    pts, cents, rows = _blobs()
    np.save(tmp_path / "points.npy", pts)
    np.save(tmp_path / "cents.npy", cents)
    seen = []
    for name, conf, run in (("port", JobConf(), lambda c: run_job(
            c, device="cpu")), ("jax", JaxJobConf(), jax_run_job)):
        conf.set("mapred.input.format.class",
                 ("tpumr_torch" if name == "port" else "tpumr")
                 + ".mapred.input_formats.DenseInputFormat")
        conf.set("mapred.input.dir", f"file://{tmp_path}/points.npy")
        conf.set("mapred.output.dir", f"file://{tmp_path}/out-{name}")
        conf.set("tpumr.dense.split.rows", rows)
        conf.set("tpumr.kmeans.centroids", f"file://{tmp_path}/cents.npy")
        conf.set("tpumr.map.kernel", "kmeans-assign")
        conf.set("mapred.reducer.class", f"{__name__}.RecordingReducer")
        conf.set("mapred.reduce.max.attempts", 1)
        RecordingReducer.calls, RecordingReducer.fail = [], fail
        try:
            ok = run(conf).successful
        except RuntimeError:
            ok = False
        assert ok is not fail
        seen.append(RecordingReducer.calls)
    assert seen == [want, want]


_KEYS = ("tpumr.task.attempt.id", "tpumr.task.partition",
         "tpumr.task.is.map")


class _KeysKernel(kmeans.KMeansAssignKernel):
    """kmeans-assign that records the task keys its drain sees."""
    name = "kmeans-assign-keys"
    seen: list = []

    def map_batch_drain(self, fetched, conf, task):
        _KeysKernel.seen.append(tuple(conf.get(k) for k in _KEYS))
        return super().map_batch_drain(fetched, conf, task)


class _JaxKeysKernel(jax_kmeans.KMeansAssignKernel):
    name = "kmeans-assign-keys"
    seen: list = []

    def map_batch_drain(self, fetched, conf, task):
        _JaxKeysKernel.seen.append(tuple(conf.get(k) for k in _KEYS))
        return super().map_batch_drain(fetched, conf, task)


class KeysReducer(kmeans.CentroidReducer):
    seen: list = []

    def configure(self, conf):
        KeysReducer.seen.append(tuple(conf.get(k) for k in _KEYS))


def test_tasks_see_localised_conf_keys_as_in_the_reference(tmp_path):
    """tpumr/mapred/map_task.py::localize_task_conf: every map and reduce
    attempt reads its own tpumr.task.attempt.id, tpumr.task.partition and
    tpumr.task.is.map, with the values the JAX runner gives them (job
    numbers aside, which each runner counts on its own)."""
    register_kernel(_KeysKernel())
    jax_register_kernel(_JaxKeysKernel())
    pts, cents, rows = _blobs()
    np.save(tmp_path / "points.npy", pts)
    np.save(tmp_path / "cents.npy", cents)
    seen = []
    for name, conf, run, kernel in (
            ("port", JobConf(), lambda c: run_job(c, device="cpu"),
             _KeysKernel),
            ("jax", JaxJobConf(), jax_run_job, _JaxKeysKernel)):
        conf.set("mapred.input.format.class",
                 ("tpumr_torch" if name == "port" else "tpumr")
                 + ".mapred.input_formats.DenseInputFormat")
        conf.set("mapred.input.dir", f"file://{tmp_path}/points.npy")
        conf.set("mapred.output.dir", f"file://{tmp_path}/out-{name}")
        conf.set("tpumr.dense.split.rows", rows)
        conf.set("tpumr.kmeans.centroids", f"file://{tmp_path}/cents.npy")
        conf.set("tpumr.map.kernel", "kmeans-assign-keys")
        conf.set("tpumr.local.run.on.tpu", True)
        conf.set("mapred.reducer.class", f"{__name__}.KeysReducer")
        kernel.seen, KeysReducer.seen = [], []
        res = run(conf)
        assert res.successful
        job = f"_{res.job_id.id:04d}_"
        seen.append([(a.replace(job, "_JOB_"), p, m)
                     for a, p, m in kernel.seen + KeysReducer.seen])
    assert seen[0] == seen[1]
    assert [s[1:] for s in seen[0]] == [(i, True) for i in range(4)] + \
        [(0, False)]
    assert re.fullmatch(r"attempt_local_JOB_m_000000_0", seen[0][0][0])


@pytest.mark.parametrize("conf,rnd", [
    ({"in": "mem:///w/cents-r{round}.npy",
      "out": "mem:///w/cents-r{next_round}.npy",
      "prev": "{prev_round}", "n": 7}, 4),   # tests/test_pipeline.py:127
    ({"in": "mem:///w/cents-r{round}.npy",
      "out": "mem:///w/cents-r{next_round}.npy",
      "prev": "{prev_round}", "n": 7}, 0),
    ({"a": "{round}{round}-{next_round}", "b": True, "c": None,
      "d": "{rounds} {x} {round"}, 11),
    ({}, 3),
])
def test_expand_round_matches_jax(conf, rnd):
    """tpumr.pipeline.graph.expand_round on the same confs."""
    assert expand_round(conf, rnd) == jax_expand_round(conf, rnd)
    if rnd == 4:
        assert expand_round(conf, rnd) == {
            "in": "mem:///w/cents-r4.npy", "out": "mem:///w/cents-r5.npy",
            "prev": "3", "n": 7}


def test_examples_kmeans_matches_jax(tmp_path, capsys):
    """tpumr_torch.examples.main(["kmeans", ...]) on the CPU against
    tpumr.examples.main(["kmeans", ...]): the final centroids agree (the
    port's maps take the window path on CPU tensors, as the JAX package's
    take its device path)."""
    pts, _cents, _rows = _wide()
    np.save(tmp_path / "points.npy", pts)
    args = [f"file://{tmp_path}/points.npy", "-k", "16", "-i", "2",
            "--split-rows", "500"]
    assert examples.main(["kmeans", args[0], f"file://{tmp_path}/port",
                          *args[1:], "-D", "tpumr_torch.device=cpu"]) == 0
    assert "Final centroids written to" in capsys.readouterr().out
    assert jax_examples.main(["kmeans", args[0], f"file://{tmp_path}/jax",
                              *args[1:]]) == 0
    got = np.load(tmp_path / "port" / "centroids.npy")
    want = np.load(tmp_path / "jax" / "centroids.npy")
    assert got.shape == (16, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert sorted(os.listdir(tmp_path / "port")) == \
        ["centroids.npy", "iter0", "iter1"]


def test_examples_kmeans_cpu_only_runs_the_numpy_batch_maps(tmp_path,
                                                            monkeypatch):
    """--cpu-only asks for the CPU and leaves tpumr.local.run.on.tpu unset:
    the numpy batch runner, whose maps equal the JAX package's
    --cpu-only run bit for bit."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.examples import basic
    pts, _cents, _rows = _wide()
    np.save(tmp_path / "points.npy", pts)
    results = []
    real = basic.run_job
    monkeypatch.setattr(basic, "run_job",
                        lambda conf: results.append(real(conf)) or
                        results[-1])
    args = [f"file://{tmp_path}/points.npy", "-k", "4", "-i", "2",
            "--split-rows", "500", "--cpu-only"]
    assert examples.main(["kmeans", args[0], f"file://{tmp_path}/port",
                          *args[1:]]) == 0
    assert jax_examples.main(["kmeans", args[0], f"file://{tmp_path}/jax",
                              *args[1:]]) == 0
    assert [r.counters.value(BackendCounter.GROUP,
                             BackendCounter.CPU_BATCH_MAP_TASKS)
            for r in results] == [4, 4]
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "centroids.npy"),
        np.load(tmp_path / "jax" / "centroids.npy"))


def test_unknown_program_returns_255(capsys):
    """tpumr.examples.main: an unknown program is rc 255 in both
    packages; so is the port's CLI without a subcommand it has."""
    assert examples.main(["nope"]) == 255
    assert "Unknown program" in capsys.readouterr().err
    assert jax_examples.main(["nope"]) == 255
    assert examples.main([]) == 255 and examples.main(["--help"]) == 0
    assert sorted(examples.programs()) == ["grep", "join", "kmeans",
                                           "matmul", "pi", "randomwriter",
                                           "secondarysort", "sleep", "sort",
                                           "teragen", "terasort",
                                           "teravalidate", "wordcount"]
    assert cli.main(["examples", "nope"]) == 255
    assert cli.main(["job"]) == 255 and cli.main([]) == 255


def test_update_reducer_needs_one_reduce():
    conf = JobConf()
    conf.set("mapred.reduce.tasks", 2)
    with pytest.raises(ValueError, match="mapred.reduce.tasks=1"):
        kmeans.KMeansCentroidUpdateReducer().configure(conf)


def test_update_reducer_keeps_empty_clusters_and_writes_no_tmp(tmp_path):
    """A cluster without points keeps its centroid; the next round's file
    is written then renamed, and the shift counts only moved clusters."""
    from tpumr_torch.mapred.api import OutputCollector, Reporter
    cents = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.save(tmp_path / "c0.npy", cents)
    conf = JobConf()
    conf.set("tpumr.kmeans.centroids", f"file://{tmp_path}/c0.npy")
    conf.set("tpumr.kmeans.centroids.out", f"file://{tmp_path}/c1.npy")
    conf.set("tpumr_torch.device", "cpu")
    red = kmeans.KMeansCentroidUpdateReducer()
    red.configure(conf)
    rep = Reporter()
    red.reduce(1, iter([(np.array([4.0, 6.0]), 1), (np.array([2.0, 2.0]),
                                                     1)]),
               OutputCollector(lambda k, v: None), rep)
    red.close()
    new = np.load(io.BytesIO((tmp_path / "c1.npy").read_bytes()))
    np.testing.assert_array_equal(new, [[0, 1], [3, 4], [4, 5]])
    assert rep.counters.value(kmeans.SHIFT_COUNTER_GROUP,
                              kmeans.SHIFT_COUNTER) == 2000
    assert sorted(os.listdir(tmp_path)) == ["c0.npy", "c1.npy"]
