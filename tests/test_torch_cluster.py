"""The port's distributed runtime on the CPU: its RPC
(tpumr_torch.ipc.rpc), job master (tpumr_torch.mapred.jobtracker), node
runners (tpumr_torch.mapred.tasktracker), shuffle fetch
(tpumr_torch.mapred.shuffle_copier) and JobClient, through its
MiniMRCluster (tpumr_torch.mapred.mini_cluster).

Oracles: tests/test_rpc.py for the RPC round trips and remote errors;
tests/test_mini_cluster.py::test_hybrid_job_uses_both_backends for the
hybrid K-Means job, run here through the JAX package's MiniMRCluster and
the port's (with tpumr_torch.device=cpu, where the accelerator slots take
the kernels' plain torch versions) on the same points; the port's
LocalJobRunner for the same job in one process; and
tests/test_mini_cluster.py::test_heartbeat_dedupe_replays_actions and
::test_commit_gate_first_wins for the master's heartbeat replay and commit
grants. Centroids agree to rtol 1e-5 and atol 1e-6, as in
tests/test_torch_job.py: each map's f32 partial sums are taken in another
order by the two packages, then averaged in float64. Every wait has a
timeout, and each cluster is stopped before its test ends.
"""

import ast
import io
import socket
import threading
import time

import numpy as np
import pytest

from tpumr.fs import get_filesystem as jax_get_filesystem
from tpumr.mapred.job_client import JobClient as JaxJobClient
from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.jobtracker import JobMaster as JaxJobMaster
from tpumr.mapred.mini_cluster import MiniMRCluster as JaxMiniMRCluster
from tpumr.ops.kmeans import clear_centroid_cache as jax_clear_centroids
from tpumr_torch.core.counters import BackendCounter
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.ipc.rpc import RpcClient, RpcError, RpcServer, get_proxy
from tpumr_torch.mapred import gpu_runner
from tpumr_torch.mapred.job_client import JobClient, build_submission
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.jobtracker import JobMaster
from tpumr_torch.mapred.local_runner import run_job as local_run_job
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.mapred.tasktracker import NodeRunner
from tpumr_torch.ops.kmeans import clear_centroid_cache

RTOL, ATOL = 1e-5, 1e-6
#: seconds any one job may take here
JOB_TIMEOUT = 60


# ------------------------------------------------------------------ RPC


class _Echo:
    def echo(self, x):
        return x

    def boom(self, msg):
        raise KeyError(msg)

    def slow_add(self, a, b):
        time.sleep(0.001)
        return a + b

    def get_protocol_version(self):
        return 7


@pytest.fixture
def rpc_server():
    server = RpcServer(_Echo()).start()
    yield server
    server.stop()


WIRE_VALUES = {
    "none": None, "true": True, "false": False, "int": -(1 << 40),
    "float": 2.5e-300, "str": "grüße", "bytes": b"\x00\xffab",
    "ndarray": np.arange(12, dtype=np.float32).reshape(3, 4),
    "list": [1, "a", [None, b"x"]], "dict": {"k": {"n": [1.5, 2]}, 3: 4},
}


@pytest.mark.parametrize("kind", sorted(WIRE_VALUES))
def test_rpc_round_trips_every_wire_type(rpc_server, kind):
    """tests/test_rpc.py: what io/writable carries crosses the wire."""
    value = WIRE_VALUES[kind]
    cli = RpcClient(*rpc_server.address)
    try:
        got = cli.call("echo", value)
    finally:
        cli.close()
    if isinstance(value, np.ndarray):
        assert got.dtype == value.dtype and np.array_equal(got, value)
    else:
        assert got == value and type(got) is type(value)


def test_rpc_remote_exception_is_rpc_error_with_its_type(rpc_server):
    proxy = get_proxy(*rpc_server.address, protocol_version=7)
    with pytest.raises(RpcError) as info:
        proxy.boom("missing thing")
    assert info.value.remote_type == "KeyError"
    assert "missing thing" in info.value.remote_message
    with pytest.raises(RpcError) as info:
        proxy.no_such_method()
    assert info.value.remote_type == "AttributeError"
    with pytest.raises(RpcError, match="protocol version mismatch"):
        get_proxy(*rpc_server.address, protocol_version=8)


def test_rpc_client_is_safe_from_several_threads(rpc_server):
    """More threads than cores share one client, with a short switch
    interval: every call gets its own answer."""
    import os
    import sys
    cli = RpcClient(*rpc_server.address)
    n = 2 * (os.cpu_count() or 4)
    results: dict = {}

    def worker(i):
        results[i] = [cli.call("slow_add", i, j) for j in range(20)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        cli.close()
    assert results == {i: [i + j for j in range(20)] for i in range(n)}


def test_rpc_named_protocol_beside_the_default(rpc_server):
    """add_protocol: a second handler answers "<name>.<method>"; the
    default handler's methods keep their bare names."""
    class _Twice:
        def echo(self, x):
            return [x, x]

    rpc_server.add_protocol("twice", _Twice())
    proxy = get_proxy(*rpc_server.address, namespace="twice")
    cli = RpcClient(*rpc_server.address)
    try:
        assert proxy.echo(3) == [3, 3]
        assert cli.call("echo", 3) == 3
        with pytest.raises(RpcError) as info:
            cli.call("nothing.echo", 3)
        assert info.value.remote_type == "AttributeError"
    finally:
        cli.close()


def test_rpc_server_binds_a_free_port_and_closes_it():
    a, b = RpcServer(_Echo()).start(), RpcServer(_Echo()).start()
    ports = (a.port, b.port)
    assert ports[0] != ports[1] and 0 not in ports
    a.stop()
    b.stop()
    for port in ports:
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=2).close()


# ------------------------------------------------------------------ jobs


def _write_npy(fs, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    fs.write_bytes(path, buf.getvalue())


def _points():
    """tests/test_mini_cluster.py::test_hybrid_job_uses_both_backends's
    data: 400 x 4 points and 3 centroids from default_rng(0)."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(400, 4)).astype(np.float32),
            rng.normal(size=(3, 4)).astype(np.float32))


def _kmeans_conf(conf, prefix, out):
    """The hybrid job of the oracle test: 16 dense splits of 25 rows, the
    kmeans-assign kernel, one reduce."""
    pkg = "tpumr_torch" if isinstance(conf, JobConf) else "tpumr"
    reducer = ("tpumr_torch.ops.kmeans.CentroidReducer" if pkg ==
               "tpumr_torch" else "tpumr.examples.basic.CentroidReducer")
    conf.set_input_paths(f"mem:///{prefix}/points.npy")
    conf.set_output_path(f"mem:///{prefix}/{out}")
    conf.set("mapred.input.format.class",
             f"{pkg}.mapred.input_formats.DenseInputFormat")
    conf.set("tpumr.dense.split.rows", 25)
    conf.set("tpumr.kmeans.centroids", f"mem:///{prefix}/cents.npy")
    conf.set("tpumr.map.kernel", "kmeans-assign")
    conf.set("mapred.mapper.class", f"{pkg}.ops.kmeans.KMeansCpuMapper")
    conf.set("mapred.reducer.class", reducer)
    conf.set_num_reduce_tasks(1)
    return conf


def _centroids(read_bytes, path):
    got = {}
    for line in read_bytes(path).decode().splitlines():
        k, v = line.split("\t")
        got[int(k)] = np.array(ast.literal_eval(v), np.float64)
    return np.stack([got[i] for i in sorted(got)])


def _port_conf():
    conf = JobConf()
    conf.set(DEVICE_KEY, "cpu")
    return conf


def _cluster_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("rpc-server", "heartbeat-", "task-",
                                  "jobmaster-"))
            or "process_request_thread" in t.name]


@pytest.fixture
def port_cluster():
    """2 runners x (2 CPU + 1 accelerator slot), on the CPU. Tests here
    fail attempts on purpose, two jobs' worth in one test, so no runner
    is blacklisted (blacklisting: tests/test_torch_speculation.py)."""
    FileSystem.clear_cache()
    clear_centroid_cache()
    gpu_runner.clear_split_caches()
    conf = _port_conf()
    conf.set("tpumr.tracker.max.faults", 1000)
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=1,
                       conf=conf) as c:
        yield c
    FileSystem.clear_cache()


def test_hybrid_kmeans_job_matches_jax_cluster_and_local_runner(port_cluster):
    pts, cents = _points()
    # the JAX package's cluster
    jfs = jax_get_filesystem("mem:///")
    _write_npy(jfs, "/hyb/points.npy", pts)
    _write_npy(jfs, "/hyb/cents.npy", cents)
    jax_clear_centroids()
    with JaxMiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=1) as jc:
        jconf = _kmeans_conf(jc.create_job_conf(), "hyb", "out")
        jst = JaxJobClient(jconf).submit_job(jconf).wait_for_completion(
            timeout=JOB_TIMEOUT)
    assert jst["state"] == "SUCCEEDED", jst
    want = _centroids(jfs.read_bytes, "/hyb/out/part-00000")

    # the port's cluster
    fs = FileSystem.get("mem:///", _port_conf())
    _write_npy(fs, "/hyb/points.npy", pts)
    _write_npy(fs, "/hyb/cents.npy", cents)
    conf = _kmeans_conf(port_cluster.create_job_conf(), "hyb", "out")
    client = JobClient(conf)
    try:
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=JOB_TIMEOUT)
        assert st["state"] == "SUCCEEDED", st
        assert st["finished_tpu_maps"] > 0 and st["finished_cpu_maps"] > 0
        assert st["finished_tpu_maps"] + st["finished_cpu_maps"] == 16
        gpu_reports = [r for r in running.task_reports("map")
                       if r["run_on_tpu"]]
        assert len(gpu_reports) == st["finished_tpu_maps"]
        assert all(r["tpu_device_id"] >= 0 for r in gpu_reports)
        assert st["cpu_map_mean_time"] > 0 and st["tpu_map_mean_time"] > 0
        assert st["acceleration_factor"] == pytest.approx(
            st["cpu_map_mean_time"] / st["tpu_map_mean_time"])
        counters = running.counters()
        assert counters.value(BackendCounter.GROUP,
                              BackendCounter.CPU_BATCH_MAP_TASKS) == \
            st["finished_cpu_maps"]
        assert counters.value(BackendCounter.GROUP,
                              BackendCounter.TPU_MAP_TASKS) == \
            st["finished_tpu_maps"]
        seq = st["placement_seq"]
        assert sorted(seq) == sorted("T" * st["finished_tpu_maps"]
                                     + "c" * st["finished_cpu_maps"])
        # the job's cleanup action reaches every runner: its served map
        # outputs and its local files go
        deadline = time.monotonic() + 10
        while any(k[0] == running.job_id for t in port_cluster.trackers
                  for k in list(t.map_outputs)):
            assert time.monotonic() < deadline, "map outputs not cleaned"
            time.sleep(0.02)
    finally:
        client.close()
    got = _centroids(fs.read_bytes, "mem:///hyb/out/part-00000")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert fs.exists("mem:///hyb/out/_SUCCESS")

    # the same job through the port's LocalJobRunner
    lconf = _kmeans_conf(_port_conf(), "hyb", "local")
    assert local_run_job(lconf).successful
    np.testing.assert_allclose(
        _centroids(fs.read_bytes, "mem:///hyb/local/part-00000"), want,
        rtol=RTOL, atol=ATOL)


def test_failing_maps_on_both_pools_fail_the_job(port_cluster):
    """A map that raises on either pool fails its attempt; the task is
    retried up to mapred.map.max.attempts and then the job fails, with
    the attempt's error in the job's status."""
    fs = FileSystem.get("mem:///", _port_conf())
    pts, _cents = _points()
    _write_npy(fs, "/bad/points.npy", pts[:100])
    conf = _kmeans_conf(port_cluster.create_job_conf(), "bad", "out")
    conf.set("tpumr.kmeans.centroids", "mem:///bad/no-such-cents.npy")
    conf.set("mapred.map.max.attempts", 2)
    client = JobClient(conf)
    try:
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=JOB_TIMEOUT)
        again = JobConf(conf)
        again.set_output_path("mem:///bad/out2")
        with pytest.raises(RuntimeError, match="FAILED"):
            client.run_job(again, timeout=JOB_TIMEOUT)
    finally:
        client.close()
    assert st["state"] == "FAILED"
    assert "failed 2 times" in st["error"]
    assert "no-such-cents" in st["error"]
    assert not fs.exists("mem:///bad/out/_SUCCESS")


def test_device_shuffled_job_is_refused_on_a_cluster(port_cluster):
    """The name is kept from when the port refused this job at submission
    (NotImplementedError). Now the same job, a device-shuffled sort of
    fixed-width records, runs on the cluster: the master holds it with one
    gang reduce, the requested reduces become its output ranges, and every
    record goes through the device shuffle, sorted
    (tests/test_device_shuffle.py::TestDeviceShuffleMiniCluster)."""
    from tpumr_torch.examples import terasort
    from tpumr_torch.io import sequencefile
    from tpumr_torch.mapred.api import IdentityMapper, RawComparator
    from tpumr_torch.mapred.input_formats import SequenceFileInputFormat
    from tpumr_torch.mapred.output_formats import SequenceFileOutputFormat
    assert terasort.teragen(["200", "mem:///dsr/gen", "-m", "2", "-D",
                             f"{DEVICE_KEY}=cpu"]) == 0
    conf = port_cluster.create_job_conf()
    conf.set_input_paths("mem:///dsr/gen")
    conf.set_output_path("mem:///dsr/out")
    conf.set_input_format(SequenceFileInputFormat)
    conf.set_mapper_class(IdentityMapper)
    conf.set_output_format(SequenceFileOutputFormat)
    conf.set_output_key_comparator_class(RawComparator)
    conf.set_num_reduce_tasks(3)
    conf.set_device_shuffle(10, 90)
    client = JobClient(conf)
    try:
        result = client.run_job(conf, timeout=JOB_TIMEOUT)
    finally:
        client.close()
    assert list(port_cluster.master.jobs) == [str(result.job_id)]
    jip = port_cluster.master.jobs[str(result.job_id)]
    assert len(jip.reduces) == 1 and jip.state == "SUCCEEDED"
    assert result.counters.value(BackendCounter.GROUP,
                                 BackendCounter.TPU_SHUFFLE_RECORDS) == 200
    fs = FileSystem.get("mem:///", _port_conf())
    parts = sorted(str(st.path) for st in fs.list_files("mem:///dsr/out")
                   if st.path.name.startswith("part-"))
    assert len(parts) == 3
    keys = []
    for p in parts:
        f = fs.open(p)
        try:
            keys += [k for k, _ in sequencefile.Reader(f)]
        finally:
            f.close()
    assert len(keys) == 200 and keys == sorted(keys)


def test_class_objects_do_not_cross_the_wire(port_cluster):
    class Local:   # not importable by name
        pass

    conf = port_cluster.create_job_conf()
    conf.set_class("mapred.mapper.class", Local)
    conf.set_input_paths("mem:///x")
    conf.set_output_path("mem:///x-out")
    with pytest.raises(ValueError, match="class object"):
        build_submission(conf)


def test_cluster_leaves_no_thread_and_no_open_port():
    before = set(_cluster_threads())
    with MiniMRCluster(num_trackers=2, cpu_slots=1, tpu_slots=1,
                       conf=_port_conf()) as c:
        ports = [c.master.address[1]] + [t.shuffle_port for t in c.trackers]
        deadline = time.monotonic() + 10
        while not all(t._response_id >= 2 for t in c.trackers):
            assert time.monotonic() < deadline, "no heartbeats"
            time.sleep(0.02)
        assert c.master.num_trackers() == 2
    deadline = time.monotonic() + 10
    while set(_cluster_threads()) - before:
        assert time.monotonic() < deadline, _cluster_threads()
        time.sleep(0.02)
    for port in ports:
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=2).close()


def test_node_runner_with_gpu_slots_needs_cuda_or_the_cpu_asked_for():
    """No CUDA here: a runner with accelerator slots raises unless the
    conf asks for the CPU; one without accelerator slots starts."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA")
    master = JobMaster(JobConf()).start()
    try:
        host, port = master.address
        conf = JobConf()
        conf.set("mapred.tasktracker.map.tpu.tasks.maximum", 1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            NodeRunner(host, port, conf)
        conf.set("mapred.tasktracker.map.tpu.tasks.maximum", 0)
        NodeRunner(host, port, conf).stop()
        conf.set("mapred.tasktracker.map.tpu.tasks.maximum", 1)
        conf.set(DEVICE_KEY, "cpu")
        runner = NodeRunner(host, port, conf, n_tpu_devices=2)
        assert runner._available_tpu_devices() == [True, True]
        runner.stop()
    finally:
        master.stop()


def test_failed_heartbeats_are_kept_and_logged_once(caplog):
    """A beat the master rejects is retried at the next interval; its
    error stays on the runner and is logged once, not once per beat."""
    master = JobMaster(JobConf()).start()
    conf = JobConf()
    conf.set("mapred.tasktracker.map.tpu.tasks.maximum", 0)
    conf.set("tpumr.heartbeat.interval.ms", 10)
    runner = NodeRunner(*master.address, conf, name="t_bad")
    beats = []

    def rejected():
        beats.append(1)
        raise ValueError("status refused")

    runner._heartbeat_once = rejected
    try:
        with caplog.at_level("WARNING", logger="tpumr_torch.mapred"):
            runner.start()
            deadline = time.monotonic() + 10
            while len(beats) < 5:
                assert time.monotonic() < deadline, "no heartbeats"
                time.sleep(0.01)
    finally:
        runner.stop()
        master.stop()
    assert runner.heartbeat_error == "ValueError: status refused"
    logged = [r for r in caplog.records if "status refused" in r.message]
    assert len(logged) == 1 and "t_bad" in logged[0].message


# ------------------------------------------------------------------ master


def _runner_status(name="t1", cpu=2):
    return {"tracker_name": name, "host": "h", "shuffle_port": 1,
            "max_cpu_map_slots": cpu, "max_tpu_map_slots": 0,
            "max_reduce_slots": 1, "count_cpu_map_tasks": 0,
            "count_tpu_map_tasks": 0, "count_reduce_tasks": 0,
            "available_tpu_devices": [], "task_statuses": []}


def _replay(master_cls, conf):
    master = master_cls(conf)
    try:
        master.submit_job({"mapred.reduce.tasks": 0},
                          [{"locations": []}, {"locations": []}])
        r1 = master.heartbeat(_runner_status(), True, True, 0)
        r2 = master.heartbeat(_runner_status(), False, True, 0)
        r3 = master.heartbeat(_runner_status(), False, True,
                              r1["response_id"])

        def shape(r):
            return (r["response_id"], [
                (a["type"], a.get("task", {}).get("partition"),
                 a.get("task", {}).get("run_on_tpu"))
                for a in r["actions"]])

        return [shape(r) for r in (r1, r2, r3)], r2["actions"] == \
            r1["actions"]
    finally:
        master.stop()


def test_heartbeat_replays_a_lost_response_as_jax():
    """test_heartbeat_dedupe_replays_actions: a beat that echoes an old
    response id gets the same actions again, and nothing new."""
    port, port_same = _replay(JobMaster, JobConf())
    jax, jax_same = _replay(JaxJobMaster, JaxJobConf())
    assert port == jax and port_same and jax_same
    assert [a[0] for a in port[0][1]] == ["launch", "launch"]


def test_kill_job_aborts_its_output():
    """A job with no runner to take its maps stays RUNNING until killed;
    the kill is final, visible to the client, and removes the job's
    temporary output."""
    with MiniMRCluster(num_trackers=0, conf=_port_conf()) as c:
        fs = FileSystem.get("mem:///", _port_conf())
        pts, cents = _points()
        _write_npy(fs, "/kill/points.npy", pts)
        _write_npy(fs, "/kill/cents.npy", cents)
        conf = _kmeans_conf(c.create_job_conf(), "kill", "out")
        client = JobClient(conf)
        try:
            running = client.submit_job(conf)
            fs.mkdirs("mem:///kill/out/_temporary")
            assert running.status()["state"] == "RUNNING"
            assert running.kill()
            assert not running.kill()
            st = running.wait_for_completion(timeout=JOB_TIMEOUT)
        finally:
            client.close()
    assert st["state"] == "KILLED" and st["finished_maps"] == 0
    assert not fs.exists("mem:///kill/out/_temporary")


def test_lost_runner_is_expired_and_its_work_requeued():
    """A runner whose heartbeats stop for tpumr.tracker.expiry.ms is
    dropped, and the map it was running goes back to pending."""
    conf = JobConf()
    conf.set("tpumr.tracker.expiry.ms", 200)
    master = JobMaster(conf).start()
    try:
        job_id = master.submit_job({"mapred.reduce.tasks": 0},
                                   [{"locations": []}])
        resp = master.heartbeat(_runner_status(cpu=1), True, True, 0)
        assert [a["type"] for a in resp["actions"]] == ["launch"]
        jip = master.jobs[job_id]
        assert jip.pending_map_count() == 0
        deadline = time.monotonic() + 10
        while master.trackers or jip.pending_map_count() != 1:
            assert time.monotonic() < deadline, "runner never expired"
            time.sleep(0.02)
        assert master.get_job_status(job_id)["state"] == "RUNNING"
    finally:
        master.stop()


def test_commit_gate_first_wins():
    master = JobMaster(JobConf())
    try:
        tid = "task_x_0001_r_000000"
        assert master.can_commit(tid, "attempt_x_0001_r_000000_0")
        assert not master.can_commit(tid, "attempt_x_0001_r_000000_1")
        assert master.can_commit(tid, "attempt_x_0001_r_000000_0")
    finally:
        master.stop()
