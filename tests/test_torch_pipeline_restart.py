"""A master restart in the middle of a pipeline on the port
(tpumr_torch.pipeline.pipeline_in_progress.PipelineInProgress.from_recovery
and apply_retired, JobMaster._recover_pipelines and its pipeline journal).

Mirrors tests/test_pipeline_restart.py::TestPipelineRestartChaos, both
chains, without the trace export: the master is stopped with nothing
finalised once the upstream stage succeeded and a new one started with
recovery on the same address; the pipeline keeps its id and succeeds with
the final output byte-identical to an undisturbed run's, and the upstream
stage keeps its one job (settled from history, never run again). Then the
same for a K-Means loop node (chip_smoke.py's master_state (b) at a small
size on the CPU): stopped after round 0's job commits, every round's
centroid file byte-identical to an undisturbed loop's, and round 0 not run
again. Every wait has a timeout, and each cluster is stopped before its
test ends.
"""

import io
import time

import numpy as np
import pytest

from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred import gpu_runner
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.jobtracker import JobMaster
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.ops.kmeans import clear_centroid_cache
from tpumr_torch.pipeline import JobGraph, PipelineClient


def _cluster_conf(tmp_path):
    conf = JobConf()
    conf.set(DEVICE_KEY, "cpu")
    conf.set("tpumr.history.dir", str(tmp_path / "history"))
    conf.set("mapred.jobtracker.restart.recover", True)
    conf.set("mapred.jobtracker.restart.recovery.grace.ms", 500)
    conf.set("tpumr.heartbeat.interval.ms", 50)
    conf.set("tpumr.tracker.expiry.ms", 60_000)
    conf.set("tpumr.rpc.client.retries", 2)
    conf.set("mapred.reduce.slowstart.completed.maps", 0.0)
    conf.set("mapred.speculative.execution", False)
    return conf


def _write_words(fs, path, lines=2500):
    fs.write_bytes(path, b"".join(b"w%02d x\n" % (i % 17)
                                  for i in range(lines)))


def _read_parts(fs, outdir):
    return b"".join(fs.read_bytes(st.path)
                    for st in sorted(fs.list_status(outdir),
                                     key=lambda s: str(s.path))
                    if "part-" in str(st.path))


def _chain_graph(name, inpath, middir, outdir, stream):
    g = JobGraph(name)
    g.node("count", {
        "mapred.input.dir": inpath,
        "mapred.output.dir": middir,
        "mapred.mapper.class": "tpumr_torch.mapred.lib.TokenCountMapper",
        "mapred.reducer.class": "tpumr_torch.examples.basic.LongSumReducer",
        "mapred.reduce.tasks": 2,
        "mapred.map.tasks": 4,
        "mapred.output.format.class":
            "tpumr_torch.mapred.output_formats.SequenceFileOutputFormat",
    })
    emit = {"mapred.output.dir": outdir,
            "mapred.mapper.class": "tpumr_torch.mapred.api.IdentityMapper",
            "mapred.reduce.tasks": 0}
    if not stream:
        emit["mapred.input.format.class"] = \
            "tpumr_torch.mapred.input_formats.SequenceFileInputFormat"
    g.node("emit", emit)
    g.edge("count", "emit", stream=stream)
    return g


def _poll_status(running, deadline_s=60.0):
    """A status poll that rides out the restart window."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            return running.status()
        except Exception:  # noqa: BLE001 — the master is restarting
            time.sleep(0.05)
    raise TimeoutError("the master never answered a pipeline status poll")


def _wait_until(running, pred, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        st = _poll_status(running)
        if pred(st):
            return st
        if st["state"] in ("FAILED", "KILLED"):
            raise AssertionError(f"the pipeline died early: {st}")
        time.sleep(0.02)
    raise TimeoutError("the pipeline never reached the awaited state")


def _wait_terminal(running, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        st = _poll_status(running)
        if st["state"] in ("SUCCEEDED", "FAILED", "KILLED"):
            return st
        time.sleep(0.05)
    raise TimeoutError("the pipeline never finished")


def _kill_and_restart_master(cluster):
    host, port = cluster.master.address
    cluster.master.stop()
    for _ in range(200):
        try:
            cluster.master = JobMaster(cluster.conf, host=host,
                                       port=port).start()
            return cluster.master
        except OSError:
            time.sleep(0.05)
    raise AssertionError("could not bind the master's port again")


@pytest.fixture(autouse=True)
def _clear_fs():
    yield
    FileSystem.clear_cache()


def _control(tmp_path, stream):
    with MiniMRCluster(num_trackers=2, tpu_slots=0,
                       conf=_cluster_conf(tmp_path / "control")) as c:
        fs = FileSystem.get("mem:///", c.conf)
        _write_words(fs, "mem:///ctl/in.txt")
        g = _chain_graph("control", "mem:///ctl/in.txt", "mem:///ctl/mid",
                         "mem:///ctl/out", stream)
        client = PipelineClient(c.create_job_conf())
        try:
            st = client.submit(g).wait_for_completion(timeout=60)
        finally:
            client.close()
        assert st["state"] == "SUCCEEDED", st
        return _read_parts(fs, "mem:///ctl/out")


@pytest.mark.parametrize("stream", [False, True], ids=["dfs", "streamed"])
def test_master_killed_mid_pipeline(tmp_path, stream):
    control = _control(tmp_path, stream)
    with MiniMRCluster(num_trackers=2, tpu_slots=0,
                       conf=_cluster_conf(tmp_path)) as c:
        fs = FileSystem.get("mem:///", c.conf)
        _write_words(fs, "mem:///pr/in.txt")
        g = _chain_graph("chaos", "mem:///pr/in.txt", "mem:///pr/mid",
                         "mem:///pr/out", stream)
        client = PipelineClient(c.create_job_conf())
        try:
            running = client.submit(g)
            pid = running.pipeline_id
            st = _wait_until(running, lambda s: s["nodes"]["count"]["state"]
                             == "SUCCEEDED")
            count_job = st["nodes"]["count"]["job_id"]
            m2 = _kill_and_restart_master(c)
            st = _wait_terminal(running)
        finally:
            client.close()
        assert st["state"] == "SUCCEEDED", st
        assert _read_parts(fs, "mem:///pr/out") == control
        # the finished upstream stage was settled from history, not rerun
        assert st["nodes"]["count"]["jobs"] == [count_job], st
        assert m2.get_metrics()["pipelines_recovered"] == 1
        assert m2.get_pipeline_status(pid)["state"] == "SUCCEEDED"


# ----------------------------------------------- a K-Means loop node


ROUNDS = 3


def _write_npy(fs, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    fs.write_bytes(path, buf.getvalue())


def _loop_graph(prefix):
    return JobGraph(f"km-{prefix}").loop("km", {
        "mapred.input.dir": "mem:///kl/points.npy",
        "mapred.output.dir": f"mem:///kl/{prefix}out-r{{round}}",
        "mapred.input.format.class":
            "tpumr_torch.mapred.input_formats.DenseInputFormat",
        "tpumr.dense.split.rows": 50,
        "tpumr.map.kernel": "kmeans-assign",
        "mapred.mapper.class": "tpumr_torch.ops.kmeans.KMeansCpuMapper",
        "mapred.reducer.class":
            "tpumr_torch.ops.kmeans.KMeansCentroidUpdateReducer",
        "mapred.reduce.tasks": 1,
        "tpumr.kmeans.centroids": f"mem:///kl/{prefix}cents-r{{round}}.npy",
        "tpumr.kmeans.centroids.out":
            f"mem:///kl/{prefix}cents-r{{next_round}}.npy",
    }, max_rounds=ROUNDS, converge={"group": "KMeans",
                                    "counter": "CENTROID_SHIFT_MILLI",
                                    "op": "lt", "value": 0})


def test_kmeans_loop_survives_a_restart_after_round_0(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.standard_normal(size=(200, 4)).astype(np.float32)
    clear_centroid_cache()
    gpu_runner.clear_split_caches()
    with MiniMRCluster(num_trackers=1, cpu_slots=0, tpu_slots=1,
                       conf=_cluster_conf(tmp_path)) as c:
        fs = FileSystem.get("mem:///", c.conf)
        _write_npy(fs, "mem:///kl/points.npy", pts)
        for prefix in ("ctl-", "rst-"):
            _write_npy(fs, f"mem:///kl/{prefix}cents-r0.npy", pts[:3])
        client = PipelineClient(c.create_job_conf())
        try:
            st = client.submit(_loop_graph("ctl-")).wait_for_completion(
                timeout=60)
            assert st["state"] == "SUCCEEDED", st
            running = client.submit(_loop_graph("rst-"))
            st = _wait_until(running, lambda s: s["nodes"]["km"]["jobs"]
                             and c.master.jobs[s["nodes"]["km"]["jobs"][0]]
                             .finalized.is_set())
            round0 = st["nodes"]["km"]["jobs"][0]
            m2 = _kill_and_restart_master(c)
            st = _wait_terminal(running)
        finally:
            client.close()
        assert st["state"] == "SUCCEEDED", st
        node = st["nodes"]["km"]
        # round 0 kept its one job; the later rounds ran once each
        assert node["jobs"][0] == round0
        assert len(set(node["jobs"])) == ROUNDS
        assert m2.get_metrics()["pipelines_recovered"] == 1
        for r in range(1, ROUNDS + 1):
            assert fs.read_bytes(f"mem:///kl/rst-cents-r{r}.npy") == \
                fs.read_bytes(f"mem:///kl/ctl-cents-r{r}.npy"), r
        # no map of round 0 ran under the restarted master
        assert m2.get_metrics()["maps_launched_tpu"] <= \
            (ROUNDS - 1) * 4
