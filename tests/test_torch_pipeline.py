"""The port's pipeline engine on the CPU: JobGraph
(tpumr_torch.pipeline.graph), the master's engine
(tpumr_torch.pipeline.pipeline_in_progress, JobMaster's pipeline RPCs), the
streamed handoff (tpumr_torch.pipeline.handoff, the reduce's tee, the node
runner's serving and purge) and PipelineClient, on the port's
MiniMRCluster with tpumr_torch.device=cpu.

Oracles: tests/test_pipeline.py, case by case (each test names the one it
mirrors). The graph cases run in both packages, and each package must
refuse each bad graph with its own PipelineError. The count stages use the
port's WordCountCpuMapper and LongSumReducer, since the port has no
mapred/lib.TokenCountMapper. Against the JAX package itself: the same
K-Means loop graph through its MiniMRCluster (KMeansCpuMapper,
tpu_slots=0), centroids within rtol 1e-5 and atol 1e-6, the tolerance of
tests/test_torch_cluster.py (each map's f32 partial sums are taken in
another order by the two packages); and the TeraSort chain, whose sorted
records are equal part for part. Every cluster runs in a with block, every
wait has a timeout, and every thread and port stops with the cluster.
"""

import os
import threading
import time

import numpy as np
import pytest

from tpumr.fs import FileSystem as JaxFileSystem
from tpumr.fs import get_filesystem as jax_get_filesystem
from tpumr.io import sequencefile as jax_seq
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.mini_cluster import MiniMRCluster as JaxMiniMRCluster
from tpumr.ops.kmeans import clear_pipeline_caches as jax_clear_pipeline
from tpumr.pipeline import JobGraph as JaxJobGraph
from tpumr.pipeline import PipelineClient as JaxPipelineClient
from tpumr.pipeline import PipelineError as JaxPipelineError
from tpumr.pipeline.graph import expand_round as jax_expand_round
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io import sequencefile
from tpumr_torch.ipc.rpc import RpcError
from tpumr_torch.mapred import jobtracker
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.ops.kmeans import SHIFT_COUNTER, SHIFT_COUNTER_GROUP
from tpumr_torch.ops.kmeans import clear_pipeline_caches
from tpumr_torch.pipeline import JobGraph, PipelineClient, PipelineError
from tpumr_torch.pipeline.graph import expand_round
from tpumr_torch.pipeline.handoff import (COUNTER_FALLBACK, COUNTER_GROUP,
                                          COUNTER_STREAMED, serve_key)

RTOL, ATOL = 1e-5, 1e-6
#: seconds any one pipeline may take here
TIMEOUT = 60

SEQ_OUT = "mapred.output_formats.SequenceFileOutputFormat"
SEQ_IN = "mapred.input_formats.SequenceFileInputFormat"


@pytest.fixture(autouse=True)
def _fresh():
    FileSystem.clear_cache()
    JaxFileSystem.clear_cache()
    yield
    FileSystem.clear_cache()
    JaxFileSystem.clear_cache()
    clear_pipeline_caches()
    jax_clear_pipeline()


# ------------------------------------------------------------ validation


def _out(**kv):
    base = {"mapred.output.dir": "mem:///p/out"}
    base.update(kv)
    return base


def _seq(pkg):
    return {"mapred.output.format.class": f"{pkg}.{SEQ_OUT}",
            "mapred.reduce.tasks": 1}


def _bad_graphs(G, pkg):
    """tests/test_pipeline.py::TestGraphValidation's graphs, each a
    callable that raises its package's PipelineError."""
    conv = {"group": "G", "counter": "C", "op": "le", "value": 0}
    return {
        "duplicate_id": lambda: G("g").node("a", _out()).node("a", _out()),
        "dangling_edge": lambda: G("g").node("a", _out()).edge(
            "a", "ghost").validate(),
        "cycle": lambda: G("g").node("a", _out()).node("b", _out()).node(
            "c", _out()).edge("a", "b").edge("b", "c").edge(
            "c", "a").validate(),
        "self_edge": lambda: G("g").node("a", _out()).edge(
            "a", "a").validate(),
        "empty": lambda: G("g").validate(),
        "no_output_dir": lambda: G("g").node(
            "a", {"mapred.reduce.tasks": 1}).validate(),
        "stream_map_only": lambda: G("g").node(
            "a", _out(**{"mapred.reduce.tasks": 0})).node(
            "b", _out()).edge("a", "b", stream=True).validate(),
        "stream_not_sequencefile": lambda: G("g").node(
            "a", _out(**{"mapred.reduce.tasks": 1})).node(
            "b", _out()).edge("a", "b", stream=True).validate(),
        "mixed_edges": lambda: G("g").node("a", _out(**_seq(pkg))).node(
            "b", _out(**_seq(pkg))).node("c", _out()).edge(
            "a", "c", stream=True).edge("b", "c").validate(),
        "converge_missing": lambda: G("g").loop(
            "a", _out(), max_rounds=2, converge={"op": "lt"}).validate(),
        "converge_op": lambda: G("g").loop(
            "a", _out(), max_rounds=2, converge=dict(conv, op="??")
        ).validate(),
        "converge_value": lambda: G("g").loop(
            "a", _out(), max_rounds=2, converge=dict(conv, value="0")
        ).validate(),
    }


@pytest.mark.parametrize("case", sorted(_bad_graphs(JobGraph,
                                                    "tpumr_torch")))
def test_bad_graph_refused_by_both_packages(case):
    """tests/test_pipeline.py::TestGraphValidation, one case each."""
    with pytest.raises(JaxPipelineError) as want:
        _bad_graphs(JaxJobGraph, "tpumr")[case]()
    with pytest.raises(PipelineError) as got:
        _bad_graphs(JobGraph, "tpumr_torch")[case]()
    assert type(got.value).__name__ == type(want.value).__name__


def _round_trip_graph(G):
    return (G("g", conf={"user.name": "alice"})
            .node("a", _out(**{"mapred.reduce.tasks": 1}))
            .loop("b", _out(), max_rounds=3,
                  converge={"group": "G", "counter": "C", "op": "le",
                            "value": 0})
            .edge("a", "b"))


def test_wire_form_and_round_expansion_match_the_jax_package():
    """::test_wire_round_trip and ::test_round_expansion: a graph written
    by either package loads in the other with the same dict."""
    want = _round_trip_graph(JaxJobGraph).validate().to_dict()
    got = _round_trip_graph(JobGraph).validate().to_dict()
    assert got == want
    assert JobGraph.from_dict(want).validate().to_dict() == want
    assert JaxJobGraph.from_dict(got).to_dict() == got
    assert JobGraph.from_dict(want).topo_order() == ["a", "b"]
    conf = {"in": "mem:///w/cents-r{round}.npy",
            "out": "mem:///w/cents-r{next_round}.npy",
            "prev": "{prev_round}", "n": 7}
    assert expand_round(conf, 4) == jax_expand_round(conf, 4) == {
        "in": "mem:///w/cents-r4.npy", "out": "mem:///w/cents-r5.npy",
        "prev": "3", "n": 7}


# ------------------------------------------------------------- cluster


def _cluster_conf(**kv):
    conf = JobConf()
    conf.set(DEVICE_KEY, "cpu")
    conf.set("mapred.reduce.slowstart.completed.maps", 0.0)
    conf.set("tpumr.heartbeat.interval.ms", 20)
    for k, v in kv.items():
        conf.set(k, v)
    return conf


def _jax_cluster_conf():
    """The JAX package's cluster at the port's heartbeat."""
    conf = JaxJobConf()
    conf.set("tpumr.heartbeat.interval.ms", 20)
    return conf


def _write_words(fs, path, lines=600):
    fs.write_bytes(path, b"".join(b"w%02d x\n" % (i % 13)
                                  for i in range(lines)))


def _read_parts(fs, outdir):
    return b"".join(fs.read_bytes(st.path)
                    for st in sorted(fs.list_status(outdir),
                                     key=lambda s: str(s.path))
                    if "part-" in str(st.path))


def _count_conf(inpath, outdir, seq_out=True, reduces=2):
    conf = {
        "mapred.input.dir": inpath,
        "mapred.output.dir": outdir,
        "mapred.input.format.class":
            "tpumr_torch.mapred.input_formats.TextInputFormat",
        "mapred.mapper.class": "tpumr_torch.ops.wordcount.WordCountCpuMapper",
        "mapred.reducer.class": "tpumr_torch.examples.basic.LongSumReducer",
        "mapred.reduce.tasks": reduces,
        "mapred.map.tasks": 3,
    }
    if seq_out:
        conf["mapred.output.format.class"] = f"tpumr_torch.{SEQ_OUT}"
    return conf


def _emit_conf(outdir, seq_in=False):
    """A map-only identity stage: (k, v) straight to text."""
    conf = {"mapred.output.dir": outdir,
            "mapred.mapper.class": "tpumr_torch.mapred.api.IdentityMapper",
            "mapred.reduce.tasks": 0}
    if seq_in:
        conf["mapred.input.format.class"] = f"tpumr_torch.{SEQ_IN}"
    return conf


def _pipeline_counters(master, st, node):
    return master.jobs[st["nodes"][node]["job_id"]].counters.value


def test_dfs_diamond_runs_off_one_submission():
    """::TestPipelineCluster::test_dfs_diamond_runs_off_one_submission."""
    with MiniMRCluster(num_trackers=2, tpu_slots=0,
                       conf=_cluster_conf()) as c:
        fs = FileSystem.get("mem:///")
        _write_words(fs, "mem:///dia/in.txt")
        g = JobGraph("diamond")
        g.node("gen", _count_conf("mem:///dia/in.txt", "mem:///dia/a",
                                  reduces=1))
        left = _count_conf("", "mem:///dia/left", reduces=1)
        left["mapred.input.format.class"] = f"tpumr_torch.{SEQ_IN}"
        left["mapred.mapper.class"] = "tpumr_torch.mapred.api.IdentityMapper"
        del left["mapred.input.dir"]   # wired by the engine
        right = dict(left, **{"mapred.output.dir": "mem:///dia/right"})
        g.node("left", left).node("right", right)
        join = dict(left, **{"mapred.output.dir": "mem:///dia/join"})
        del join["mapred.output.format.class"]
        g.node("join", join)
        g.edge("gen", "left").edge("gen", "right")
        g.edge("left", "join").edge("right", "join")
        client = PipelineClient(c.create_job_conf())
        try:
            running = client.submit(g)
            st = running.wait_for_completion(poll_s=0.05, timeout=TIMEOUT)
        finally:
            client.close()
        assert st["state"] == "SUCCEEDED", st
        assert all(n["state"] == "SUCCEEDED" for n in st["nodes"].values())
        # the join read both branches: every word's count twice
        out = _read_parts(fs, "mem:///dia/join").decode().splitlines()
        counts = {}
        for line in out:
            k, v = line.split("\t")
            counts[k] = counts.get(k, 0) + int(v)
        assert counts == {**{f"w{i:02d}": 2 * (46 + (i < 2))
                             for i in range(13)}, "x": 1200}
        jobs = {nid: n["job_id"] for nid, n in st["nodes"].items()}
        assert len(set(jobs.values())) == 4
        m = c.master
        # stage jobs take the pipeline's place in the FIFO queue
        assert {m.jobs[j].sched_anchor for j in jobs.values()} == {
            m.pipelines[running.pipeline_id].start_time}
        assert m.get_pipeline_status(running.pipeline_id)["state"] == \
            "SUCCEEDED"
        assert [p["pipeline_id"] for p in m.list_pipelines()] == \
            [running.pipeline_id]


def test_streamed_handoff_matches_dfs_chain_and_is_purged():
    """::TestPipelineCluster::test_streamed_handoff_matches_dfs_chain."""
    with MiniMRCluster(num_trackers=2, tpu_slots=0,
                       conf=_cluster_conf()) as c:
        fs = FileSystem.get("mem:///")
        _write_words(fs, "mem:///st/in.txt")
        g1 = JobGraph("chain-dfs")
        g1.node("count", _count_conf("mem:///st/in.txt", "mem:///st/d-mid"))
        g1.node("emit", _emit_conf("mem:///st/d-out", seq_in=True))
        g1.edge("count", "emit")
        g2 = JobGraph("chain-stream")
        g2.node("count", _count_conf("mem:///st/in.txt", "mem:///st/s-mid"))
        g2.node("emit", _emit_conf("mem:///st/s-out"))
        g2.edge("count", "emit", stream=True)
        client = PipelineClient(c.create_job_conf())
        try:
            st1 = client.submit(g1).wait_for_completion(poll_s=0.05,
                                                        timeout=TIMEOUT)
            st2 = client.submit(g2).wait_for_completion(poll_s=0.05,
                                                        timeout=TIMEOUT)
        finally:
            client.close()
        assert st1["state"] == st2["state"] == "SUCCEEDED", (st1, st2)
        out_dfs = _read_parts(fs, "mem:///st/d-out")
        assert out_dfs and _read_parts(fs, "mem:///st/s-out") == out_dfs
        m = c.master
        value = _pipeline_counters(m, st2, "emit")
        assert value(COUNTER_GROUP, COUNTER_STREAMED) == 2
        assert value(COUNTER_GROUP, COUNTER_FALLBACK) == 0
        assert _pipeline_counters(m, st1, "emit")(
            COUNTER_GROUP, COUNTER_STREAMED) == 0
        count_job = st2["nodes"]["count"]["job_id"]
        events = m.get_handoff_completion_events(count_job, 0)
        assert sorted(e["map_index"] for e in events) == [0, 1]
        assert all(e["status"] == "SUCCEEDED" for e in events)
        assert m.get_handoff_completion_events(
            st1["nodes"]["count"]["job_id"], 0) == []
        # the pipeline is over: the runners' sweeps drop the copies
        assert m.handoff_purgeable(count_job) is True
        deadline = time.monotonic() + 15
        while any(k[0] == serve_key(count_job)
                  for t in c.trackers for k in list(t.map_outputs)):
            assert time.monotonic() < deadline, "handoff entries not purged"
            time.sleep(0.05)
        for t in c.trackers:
            assert not os.path.exists(os.path.join(t.local_root, "handoff",
                                                   count_job))


def test_kill_pipeline():
    """::TestPipelineCluster::test_kill_pipeline."""
    with MiniMRCluster(num_trackers=1, tpu_slots=0,
                       conf=_cluster_conf()) as c:
        fs = FileSystem.get("mem:///")
        _write_words(fs, "mem:///kp/in.txt", lines=4000)
        g = JobGraph("killme")
        g.node("a", _count_conf("mem:///kp/in.txt", "mem:///kp/a"))
        g.node("b", _emit_conf("mem:///kp/out", seq_in=True))
        g.edge("a", "b")
        client = PipelineClient(c.create_job_conf())
        try:
            running = client.submit(g)
            assert running.kill() is True
            st = running.wait_for_completion(poll_s=0.05, timeout=TIMEOUT)
            assert running.kill() is False   # already over
        finally:
            client.close()
        assert st["state"] == "KILLED"
        assert st["nodes"]["a"]["state"] == "FAILED"
        assert st["nodes"]["b"]["state"] == "SKIPPED"
        assert c.master.jobs[st["nodes"]["a"]["job_id"]].state == "KILLED"


def test_failed_stage_fails_pipeline_and_skips_downstream():
    """::TestPipelineCluster::test_failed_stage_fails_pipeline_and_skips_
    downstream."""
    with MiniMRCluster(num_trackers=1, tpu_slots=0,
                       conf=_cluster_conf()) as c:
        g = JobGraph("doomed")
        g.node("a", _count_conf("mem:///nope/missing.txt", "mem:///no/a"))
        g.node("b", _emit_conf("mem:///no/out", seq_in=True))
        g.edge("a", "b")
        client = PipelineClient(c.create_job_conf())
        try:
            st = client.submit(g).wait_for_completion(poll_s=0.05,
                                                      timeout=TIMEOUT)
        finally:
            client.close()
        assert st["state"] == "FAILED"
        assert st["nodes"]["a"]["state"] == "FAILED"
        assert st["nodes"]["b"]["state"] == "SKIPPED"
        assert "missing.txt" in st["error"]


# ------------------------------------------------------------ terasort


def _terasort_graph(G, pkg, root, stream):
    """tests/test_pipeline.py::TestTerasortPipeline::_graph, for either
    package: teragen -> sort (partition sampling in the master's hook) ->
    validate."""
    g = G(f"terasort-{'str' if stream else 'dfs'}")
    g.node("gen", {
        "mapred.input.dir": f"{root}/rows.txt",
        "mapred.output.dir": f"{root}/gen",
        "mapred.input.format.class":
            f"{pkg}.mapred.input_formats.NLineInputFormat",
        "mapred.line.input.format.linespermap": 1,
        "mapred.mapper.class": f"{pkg}.examples.terasort.TeraGenMapper",
        "mapred.output.format.class": f"{pkg}.{SEQ_OUT}",
        "mapred.reduce.tasks": 0,
    })
    g.node("sort", {
        "mapred.output.dir": f"{root}/sorted",
        "mapred.input.format.class": f"{pkg}.{SEQ_IN}",
        "mapred.mapper.class": f"{pkg}.examples.terasort.TeraSortMapper",
        "mapred.reducer.class": f"{pkg}.mapred.api.IdentityReducer",
        "mapred.output.format.class": f"{pkg}.{SEQ_OUT}",
        "mapred.output.key.comparator.class":
            f"{pkg}.mapred.api.RawComparator",
        "mapred.reduce.tasks": 2,
    }, conf_hook=f"{pkg}.examples.terasort.pipeline_sort_hook")
    validate = {
        "mapred.output.dir": f"{root}/ok",
        "mapred.mapper.class": f"{pkg}.examples.terasort.TeraValidateMapper",
        "mapred.reducer.class":
            f"{pkg}.examples.terasort.TeraValidateReducer",
        "mapred.reduce.tasks": 1,
    }
    if not stream:
        validate["mapred.input.format.class"] = f"{pkg}.{SEQ_IN}"
        validate["mapred.min.split.size"] = 1 << 60
    g.node("validate", validate)
    g.edge("gen", "sort")
    g.edge("sort", "validate", stream=stream)
    return g


def _seq_parts(fs, reader_cls, outdir):
    out = []
    for st in sorted(fs.list_status(outdir), key=lambda s: str(s.path)):
        if "part-" not in str(st.path):
            continue
        f = fs.open(st.path)
        try:
            out.append(list(reader_cls(f).iter_range(0, st.length)))
        finally:
            f.close()
    return out


def test_terasort_chain_streamed_equals_dfs_and_the_jax_package(tmp_path):
    """::TestTerasortPipeline::test_teragen_sort_validate_streamed_vs_dfs
    at 400 rows over 2 teragen maps, and the same chain on the JAX
    package's cluster."""
    rows = b"0 200\n200 200\n"
    jfs = jax_get_filesystem("mem:///")
    jfs.write_bytes("/jts/rows.txt", rows)
    with JaxMiniMRCluster(num_trackers=1, tpu_slots=0,
                          conf=_jax_cluster_conf()) as jc:
        jcli = JaxPipelineClient(jc.create_job_conf())
        try:
            jst = jcli.submit(_terasort_graph(
                JaxJobGraph, "tpumr", "mem:///jts", False)) \
                .wait_for_completion(poll_s=0.05, timeout=TIMEOUT)
        finally:
            jcli._client.close()   # the JAX package's client has no close()
    assert jst["state"] == "SUCCEEDED", jst
    want = _seq_parts(jfs, jax_seq.Reader, "/jts/sorted")

    with MiniMRCluster(num_trackers=2, tpu_slots=0,
                       conf=_cluster_conf()) as c:
        fs = FileSystem.get("mem:///")
        got, ok = {}, {}
        client = PipelineClient(c.create_job_conf())
        try:
            for tag, stream in (("dfs", False), ("str", True)):
                root = f"mem:///ts-{tag}"
                fs.write_bytes(f"{root}/rows.txt", rows)
                st = client.submit(_terasort_graph(
                    JobGraph, "tpumr_torch", root, stream)) \
                    .wait_for_completion(poll_s=0.05, timeout=TIMEOUT)
                assert st["state"] == "SUCCEEDED", st
                got[tag] = _seq_parts(fs, sequencefile.Reader,
                                      f"{root}/sorted")
                ok[tag] = _read_parts(fs, f"{root}/ok")
                value = _pipeline_counters(c.master, st, "validate")
                assert value(COUNTER_GROUP, COUNTER_STREAMED) == \
                    (2 if stream else 0)
                assert value(COUNTER_GROUP, COUNTER_FALLBACK) == 0
        finally:
            client.close()
    assert sum(len(p) for p in want) == 400
    assert got["dfs"] == got["str"] == want
    assert ok["dfs"] == ok["str"] == b""
    assert fs.read_bytes("mem:///ts-str/sorted.partitions") == \
        jfs.read_bytes("/jts/sorted.partitions")


# ---------------------------------------------------------- loop nodes


def _kmeans_loop_conf(pkg, work, rows=16):
    """tests/test_pipeline.py::_kmeans_loop_conf, for either package."""
    return {
        "mapred.input.dir": f"file://{work}/points.npy",
        "mapred.output.dir": f"file://{work}/out-r{{round}}",
        "mapred.input.format.class":
            f"{pkg}.mapred.input_formats.DenseInputFormat",
        "tpumr.dense.split.rows": rows,
        "mapred.mapper.class": f"{pkg}.ops.kmeans.KMeansCpuMapper",
        "mapred.reducer.class":
            f"{pkg}.ops.kmeans.KMeansCentroidUpdateReducer",
        "mapred.reduce.tasks": 1,
        "tpumr.kmeans.centroids": f"file://{work}/cents-r{{round}}.npy",
        "tpumr.kmeans.centroids.out":
            f"file://{work}/cents-r{{next_round}}.npy",
    }


def _kmeans_work(work, n=48, d=2):
    """tests/test_pipeline.py::_kmeans_work: two tight blobs."""
    rng = np.random.default_rng(7)
    a = rng.normal(0.0, 0.1, size=(n // 2, d)).astype(np.float32)
    b = rng.normal(5.0, 0.1, size=(n // 2, d)).astype(np.float32)
    np.save(f"{work}/points.npy", np.concatenate([a, b]))
    return np.stack([a.mean(axis=0), b.mean(axis=0)])


def _run_loop(conf, graph):
    client = PipelineClient(conf)
    try:
        return client.submit(graph).wait_for_completion(poll_s=0.05,
                                                        timeout=TIMEOUT)
    finally:
        client.close()


def test_loop_convergence_settles_early(tmp_path):
    """::TestLoopNodes::test_convergence_settles_early."""
    work = str(tmp_path)
    means = _kmeans_work(work)
    np.save(f"{work}/cents-r0.npy", means.astype(np.float32))
    with MiniMRCluster(num_trackers=1, tpu_slots=0,
                       conf=_cluster_conf()) as c:
        g = JobGraph("kmeans").loop(
            "km", _kmeans_loop_conf("tpumr_torch", work), max_rounds=5,
            converge={"group": SHIFT_COUNTER_GROUP,
                      "counter": SHIFT_COUNTER, "op": "le", "value": 5})
        st = _run_loop(c.create_job_conf(), g)
    assert st["state"] == "SUCCEEDED", st
    assert st["nodes"]["km"]["rounds_run"] == 1
    assert np.allclose(np.load(f"{work}/cents-r1.npy"), means, atol=1e-3)
    assert not os.path.exists(f"{work}/cents-r2.npy")


def test_loop_max_rounds_cutoff_matches_the_jax_package(tmp_path):
    """::TestLoopNodes::test_max_rounds_cutoff_and_versioned_centroids,
    and the same graph on the JAX package's cluster."""
    start = np.array([[10.0, 10.0], [-10.0, -10.0]], np.float32)
    files = {}
    for pkg in ("tpumr", "tpumr_torch"):
        work = str(tmp_path / pkg)
        os.makedirs(work)
        means = _kmeans_work(work)
        np.save(f"{work}/cents-r0.npy", start)
        G, cluster = ((JaxJobGraph, JaxMiniMRCluster) if pkg == "tpumr"
                      else (JobGraph, MiniMRCluster))
        conf = _jax_cluster_conf() if pkg == "tpumr" else _cluster_conf()
        g = G("kmeans-cutoff").loop(
            "km", _kmeans_loop_conf(pkg, work), max_rounds=3,
            converge={"group": SHIFT_COUNTER_GROUP,
                      "counter": SHIFT_COUNTER, "op": "lt", "value": 0})
        with cluster(num_trackers=1, tpu_slots=0, conf=conf) as c:
            if pkg == "tpumr":
                jcli = JaxPipelineClient(c.create_job_conf())
                try:
                    st = jcli.submit(g).wait_for_completion(
                        poll_s=0.05, timeout=TIMEOUT)
                finally:
                    jcli._client.close()   # no close() of its own
            else:
                st = _run_loop(c.create_job_conf(), g)
        assert st["state"] == "SUCCEEDED", st
        assert st["nodes"]["km"]["rounds_run"] == 3
        for r in range(4):
            assert os.path.exists(f"{work}/cents-r{r}.npy")
        files[pkg] = [np.load(f"{work}/cents-r{r}.npy") for r in range(4)]
    assert np.allclose(np.sort(files["tpumr_torch"][3], axis=0),
                       np.sort(means, axis=0), atol=0.2)
    for got, want in zip(files["tpumr_torch"], files["tpumr"]):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------ fallback and allowlist

#: the fallback test's gate on its downstream stage's submission
_GATE = {}


def hold_stage(conf, upstreams):
    """conf_hook: the stage submits only once the test opens the gate."""
    assert _GATE["open"].wait(TIMEOUT), "the gate never opened"


def test_stream_of_a_lost_runner_falls_back_to_the_committed_part():
    """A streamed partition whose serving runner is lost is read from the
    upstream's committed part file (the JAX package's
    PipelineHandoffInputFormat._try_fallback, after
    JobInProgress.withdraw_handoff_at)."""
    _GATE["open"] = threading.Event()
    conf = _cluster_conf(**{
        "tpumr.tracker.expiry.ms": 1000,
        # one reduce a runner: the two partitions land on both runners
        "mapred.tasktracker.reduce.tasks.maximum": 1,
        "tpumr.pipeline.conf.hooks.allowed": f"{__name__}."})
    with MiniMRCluster(num_trackers=2, tpu_slots=0, conf=conf) as c:
        fs = FileSystem.get("mem:///")
        _write_words(fs, "mem:///fb/in.txt")
        g = JobGraph("fallback")
        g.node("count", _count_conf("mem:///fb/in.txt", "mem:///fb/mid"))
        g.node("emit", _emit_conf("mem:///fb/out"),
               conf_hook=f"{__name__}.hold_stage")
        g.edge("count", "emit", stream=True)
        deadline = time.monotonic() + TIMEOUT
        while not all(t._response_id >= 2 for t in c.trackers):
            assert time.monotonic() < deadline, "runners never beat"
            time.sleep(0.02)
        client = PipelineClient(c.create_job_conf())
        try:
            running = client.submit(g)
            m = c.master
            while True:
                count_job = running.status()["nodes"]["count"]["job_id"]
                jip = m.jobs.get(count_job)
                if jip is not None and jip.finalized.is_set():
                    break
                assert time.monotonic() < deadline, "count never ended"
                time.sleep(0.02)
            assert jip.state == "SUCCEEDED"
            served = {e["map_index"]: e["shuffle_addr"]
                      for e in m.get_handoff_completion_events(count_job)}
            assert sorted(served) == [0, 1] and \
                served[0] != served[1], served
            lost = next(t for t in c.trackers
                        if served[1].endswith(f":{t.shuffle_port}"))
            c.trackers.remove(lost)
            lost.stop()
            while not any(e["status"] == "OBSOLETE" for e in
                          m.get_handoff_completion_events(count_job)):
                assert time.monotonic() < deadline, "runner never expired"
                time.sleep(0.05)
            _GATE["open"].set()
            st = running.wait_for_completion(poll_s=0.05, timeout=TIMEOUT)
        finally:
            _GATE["open"].set()
            client.close()
        assert st["state"] == "SUCCEEDED", st
        value = _pipeline_counters(m, st, "emit")
        assert value(COUNTER_GROUP, COUNTER_STREAMED) == 1
        assert value(COUNTER_GROUP, COUNTER_FALLBACK) == 1
        words = sorted(_read_parts(fs, "mem:///fb/out").decode()
                       .splitlines())
        assert words == sorted([f"w{i:02d}\t{46 + (i < 2)}"
                                for i in range(13)] + ["x\t600"])


def test_hook_outside_the_allowlist_is_refused_at_submit():
    """JobMaster.submit_pipeline's allowlist, whose port default is
    tpumr_torch. where the JAX package's is tpumr. (a deliberate
    difference: the JAX default admits no hook of the port)."""
    from tpumr.core import confkeys
    assert confkeys.get(JaxJobConf(),
                        "tpumr.pipeline.conf.hooks.allowed") == "tpumr."
    assert jobtracker.HOOKS_ALLOWED_DEFAULT == "tpumr_torch."
    with MiniMRCluster(num_trackers=1, tpu_slots=0,
                       conf=_cluster_conf()) as c:
        client = PipelineClient(c.create_job_conf())
        try:
            for hook in ("tpumr.examples.terasort.pipeline_sort_hook",
                         "os.system"):
                g = JobGraph("hooked").node("a", _out(), conf_hook=hook)
                with pytest.raises(RpcError) as e:
                    client.submit(g)
                assert e.value.remote_type == "PermissionError"
                assert "allowed prefix" in str(e.value)
            assert client.list() == []   # nothing was admitted
        finally:
            client.close()
