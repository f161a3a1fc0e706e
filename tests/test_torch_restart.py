"""A master restart on the port (tpumr_torch.mapred.jobtracker.JobMaster's
recovery, the node runner's lost-master state and rebinding,
tpumr_torch.mapred.job_client.RunningJob following a recovered job)
against the JAX package's.

Mirrors tests/test_master_restart.py's TestMasterRestartRecovery (each
case driven through both packages' masters with the same heartbeats, the
counts read from the JAX package's metrics registry and from the port's
``get_metrics``), TestJobRebindServing, TestTrackerLostMaster and
TestEndToEndRestartChaos (both tests, without their trace asserts), and
tests/test_reliability.py's TestRecovery, TestFinalizeIdempotent and
TestRecoveryPriority. Last, the hybrid K-Means job through a master
restart on the port's cluster (``tpumr_torch.device=cpu``), held against
the same job on the JAX package's cluster, centroids to rtol 1e-5 and
atol 1e-6 as in tests/test_torch_cluster.py.

Where a job must still be running when its master is stopped, one map is
a ``task.slow`` straggler (``tpumr.fi.task.slow.ms``): the reference's
maps over 3,000 lines race the stop on a fast machine. Every wait has a
timeout, and each cluster is stopped before its test ends.
"""

import ast
import io
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import tpumr.mapred.jobconf as jax_jobconf
import tpumr.mapred.jobtracker as jax_jobtracker
import tpumr.mapred.task as jax_task
import tpumr_torch.mapred.task as port_task
from tpumr.fs import get_filesystem as jax_get_filesystem
from tpumr.mapred.job_client import JobClient as JaxJobClient
from tpumr.mapred.mini_cluster import MiniMRCluster as JaxMiniMRCluster
from tpumr.ops.kmeans import clear_centroid_cache as jax_clear_centroids
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred import gpu_runner
from tpumr_torch.mapred.history import JobHistory
from tpumr_torch.mapred.ids import JobID, TaskAttemptID
from tpumr_torch.mapred.job_client import JobClient
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.jobtracker import JobMaster
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.mapred.task import TaskPhase, TaskState
from tpumr_torch.mapred.tasktracker import NodeRunner
from tpumr_torch.ops.kmeans import clear_centroid_cache
from tpumr_torch.utils import fi

JAX = SimpleNamespace(name="jax", JobMaster=jax_jobtracker.JobMaster,
                      JobConf=jax_jobconf.JobConf, task=jax_task)
PORT = SimpleNamespace(name="port", JobMaster=JobMaster, JobConf=JobConf,
                       task=port_task)
PKGS = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
RTOL, ATOL = 1e-5, 1e-6
#: seconds any one job may take here
JOB_TIMEOUT = 60


def _metrics(pkg, master) -> dict:
    if pkg is JAX:
        return master.metrics.snapshot()["jobtracker"]
    return master.get_metrics()


def _conf(pkg, tmp_path, **extra):
    conf = pkg.JobConf()
    conf.set("tpumr.history.dir", str(tmp_path))
    conf.set("mapred.jobtracker.restart.recover", True)
    for k, v in extra.items():
        conf.set(k, v)
    return conf


# ------------------------------------------------ master-level recovery


def _tracker_status(name="t1", host="h1", port=70, cpu=2, reduce=2,
                    statuses=()):
    return {"tracker_name": name, "host": host,
            "shuffle_addr": f"{host}:{port}", "shuffle_port": port,
            "max_cpu_map_slots": cpu, "max_tpu_map_slots": 0,
            "max_reduce_slots": reduce, "count_cpu_map_tasks": 0,
            "count_tpu_map_tasks": 0, "count_reduce_tasks": 0,
            "available_tpu_devices": [], "available_memory_mb": -1,
            "task_statuses": [dict(s) for s in statuses],
            "fetch_failures": [], "healthy": True, "health_report": ""}


def _succeeded(aid, runtime=0.2):
    now = time.time()
    return {"attempt_id": aid, "is_map": "_m_" in aid,
            "state": TaskState.SUCCEEDED, "progress": 1.0,
            "phase": TaskPhase.MAP if "_m_" in aid else TaskPhase.REDUCE,
            "start_time": now - runtime, "finish_time": now,
            "diagnostics": "", "counters": {}, "run_on_tpu": False,
            "tpu_device_id": -1, "failure_class": ""}


def _running(aid, progress=0.5):
    return {"attempt_id": aid, "is_map": "_m_" in aid,
            "state": TaskState.RUNNING, "progress": progress,
            "phase": TaskPhase.MAP if "_m_" in aid else TaskPhase.SHUFFLE,
            "start_time": time.time(), "finish_time": 0.0,
            "diagnostics": "", "counters": {}, "run_on_tpu": False,
            "tpu_device_id": -1, "failure_class": ""}


def _interrupt_job(pkg, tmp_path):
    """Master 1: a 3-map, 1-reduce job; 2 maps run to completion over the
    heartbeat path, map 2 left running; then stopped with nothing
    finalised. Returns (old job id, the running attempt)."""
    m1 = pkg.JobMaster(_conf(pkg, tmp_path)).start()
    try:
        old_id = m1.submit_job(
            {"mapred.job.name": "interrupted", "mapred.reduce.tasks": 1,
             "mapred.reduce.slowstart.completed.maps": 1.0},
            [{"locations": []} for _ in range(3)])
        r = m1.heartbeat(_tracker_status(cpu=3), True, True, 0)
        aids = [a["task"]["attempt_id"] for a in r["actions"]
                if a["type"] == "launch"]
        assert len(aids) == 3
        m1.heartbeat(_tracker_status(statuses=[
            _succeeded(a) for a in aids[:2]] + [_running(aids[2])]),
            False, False, r["response_id"])
    finally:
        m1.stop()
    return old_id, aids[2]


@PKGS
def test_attempt_level_recovery_and_alias(pkg, tmp_path):
    old_id, _ = _interrupt_job(pkg, tmp_path)
    m2 = pkg.JobMaster(_conf(pkg, tmp_path)).start()
    try:
        snap = _metrics(pkg, m2)
        assert snap["jobs_recovered"] == 1
        assert snap["attempts_recovered"] == 2
        mapping = m2.get_recovered_jobs()
        assert list(mapping) == [old_id]
        new_id = mapping[old_id]
        st = m2.get_job_status(old_id)
        assert st["job_id"] == new_id and st["finished_maps"] == 2
        events = m2.get_map_completion_events(new_id, 0)
        assert {e["map_index"] for e in events} == {0, 1}
        assert all(e["shuffle_addr"] == "h1:70" for e in events)
        jip = m2.jobs[new_id]
        assert jip.recovered_from == old_id
        assert jip.pending_map_count() == 1
        # the grace: map 2 waits for its runner to rejoin
        assert jip.obtain_new_map_task("h1", False) is None
    finally:
        m2.stop()


@PKGS
def test_rejoining_tracker_adopted_not_reinit(pkg, tmp_path):
    old_id, running_aid = _interrupt_job(pkg, tmp_path)
    m2 = pkg.JobMaster(_conf(pkg, tmp_path)).start()
    try:
        new_id = m2.get_recovered_jobs()[old_id]
        dead_aid = "attempt_dead_0009_m_000000_0"
        r = m2.heartbeat(_tracker_status(
            statuses=[_running(running_aid), _running(dead_aid)]),
            False, True, 7)
        kinds = [a["type"] for a in r["actions"]]
        assert "reinit" not in kinds and "resend_full" not in kinds
        jip = m2.jobs[new_id]
        assert jip.pending_map_count() == 0
        assert jip.maps[2].state == "running"
        assert [a["attempt_id"] for a in r["actions"]
                if a["type"] == "kill_task"] == [dead_aid]
        assert [a for a in r["actions"] if a["type"] == "recover_job"] == \
            [{"type": "recover_job", "old": old_id, "new": new_id}]
        snap = _metrics(pkg, m2)
        assert snap["trackers_adopted"] == 1
        assert snap["attempts_adopted"] == 1
        m2.heartbeat(_tracker_status(statuses=[_succeeded(running_aid)]),
                     False, False, r["response_id"])
        assert m2.get_job_status(old_id)["finished_maps"] == 3
        snap = _metrics(pkg, m2)
        assert snap.get("maps_launched_cpu", 0) == 0
        assert snap.get("maps_launched_tpu", 0) == 0
    finally:
        m2.stop()


@PKGS
def test_commit_gate_follows_alias(pkg, tmp_path):
    old_id, running_aid = _interrupt_job(pkg, tmp_path)
    m2 = pkg.JobMaster(_conf(pkg, tmp_path)).start()
    try:
        task_id = str(TaskAttemptID.parse(running_aid).task)
        m2.heartbeat(_tracker_status(statuses=[_running(running_aid)]),
                     False, False, 3)
        assert m2.can_commit(task_id, running_aid) is True
    finally:
        m2.stop()


@PKGS
def test_finished_job_served_retired_from_history(pkg, tmp_path):
    m1 = pkg.JobMaster(_conf(pkg, tmp_path)).start()
    try:
        jid = m1.submit_job({"mapred.job.name": "done",
                             "mapred.reduce.tasks": 0}, [{"locations": []}])
        r = m1.heartbeat(_tracker_status(), True, True, 0)
        aid = [a for a in r["actions"]
               if a["type"] == "launch"][0]["task"]["attempt_id"]
        m1.heartbeat(_tracker_status(statuses=[_succeeded(aid)]),
                     False, False, r["response_id"])
        assert m1.get_job_status(jid)["state"] == "SUCCEEDED"
    finally:
        m1.stop()
    m2 = pkg.JobMaster(_conf(pkg, tmp_path)).start()
    try:
        assert m2.get_recovered_jobs() == {}
        st = m2.get_job_status(jid)
        assert st["state"] == "SUCCEEDED" and st["retired"] is True
        assert st["num_maps"] == 1 and st["finished_maps"] == 1
        with pytest.raises(KeyError):
            m2.get_job_status("job_never_0001")
    finally:
        m2.stop()


@PKGS
def test_withdrawn_output_not_recovered_after_eviction(pkg, tmp_path):
    conf = _conf(pkg, tmp_path, **{"tpumr.tracker.expiry.ms": 60_000})
    m1 = pkg.JobMaster(conf).start()
    try:
        old_id = m1.submit_job({"mapred.job.name": "evicted",
                                "mapred.reduce.tasks": 1},
                               [{"locations": []}])
        r = m1.heartbeat(_tracker_status(), True, True, 0)
        aid = [a for a in r["actions"]
               if a["type"] == "launch"][0]["task"]["attempt_id"]
        m1.heartbeat(_tracker_status(statuses=[_succeeded(aid)]),
                     False, False, r["response_id"])
        assert m1.jobs[old_id].finished_maps == 1
        if pkg is JAX:
            m1._evict_tracker("t1")
        else:
            m1._requeue_tracker_work(m1.trackers.pop("t1"))
        assert m1.jobs[old_id].finished_maps == 0
    finally:
        m1.stop()
    m2 = pkg.JobMaster(_conf(pkg, tmp_path)).start()
    try:
        new_id = m2.get_recovered_jobs()[old_id]
        assert m2.jobs[new_id].finished_maps == 0
        assert m2.jobs[new_id].pending_map_count() == 1
    finally:
        m2.stop()


# ------------------------------------ tests/test_reliability.py's three


@PKGS
def test_jobmaster_restart_recovers_incomplete_jobs(pkg, tmp_path):
    """TestRecovery: recovered once, and not again by a third master."""
    conf = pkg.JobConf()
    conf.set("tpumr.history.dir", str(tmp_path))
    jm = pkg.JobMaster(conf).start()
    try:
        jid = jm.submit_job({"mapred.job.name": "interrupted",
                             "mapred.reduce.tasks": 0},
                            [{"locations": []}, {"locations": []}])
        assert jm.jobs[jid].state == "RUNNING"
    finally:
        jm.stop()
    conf2 = _conf(pkg, tmp_path)
    for _ in range(2):
        jm2 = pkg.JobMaster(conf2).start()
        try:
            recovered = [j for j in jm2.jobs.values()
                         if j.conf.get("mapred.job.name") == "interrupted"]
            assert len(recovered) == 1 and recovered[0].num_maps == 2
        finally:
            jm2.stop()


@PKGS
def test_double_finalize_emits_one_history_event(pkg, tmp_path):
    """TestFinalizeIdempotent."""
    conf = pkg.JobConf()
    conf.set("tpumr.history.dir", str(tmp_path))
    jm = pkg.JobMaster(conf).start()
    try:
        jid = jm.submit_job({"mapred.job.name": "dupfin",
                             "mapred.reduce.tasks": 0}, [{"locations": []}])
        jip = jm.jobs[jid]
        jip.kill()
        jm._finalize_job(jip)
        jm._finalize_job(jip)
        assert jm.kill_job(jid) is False
    finally:
        jm.stop()
    events = [e for f in os.listdir(tmp_path) if f.endswith(".jsonl")
              for e in open(os.path.join(tmp_path, f))
              if '"JOB_FINISHED"' in e]
    assert len(events) == 1


@PKGS
def test_restart_preserves_runtime_priority_change(pkg, tmp_path):
    """TestRecoveryPriority."""
    conf = pkg.JobConf()
    conf.set("tpumr.history.dir", str(tmp_path))
    jm = pkg.JobMaster(conf).start()
    try:
        jid = jm.submit_job({"mapred.job.name": "bumped",
                             "mapred.reduce.tasks": 0}, [{"locations": []}])
        assert jm.jobs[jid].priority == "NORMAL"
        args = (jid, "VERY_HIGH") + (("anyone",) if pkg is JAX else ())
        assert jm.set_job_priority(*args) == "VERY_HIGH"
    finally:
        jm.stop()
    jm2 = pkg.JobMaster(_conf(pkg, tmp_path)).start()
    try:
        recovered = [j for j in jm2.jobs.values()
                     if j.conf.get("mapred.job.name") == "bumped"]
        assert len(recovered) == 1 and recovered[0].priority == "VERY_HIGH"
    finally:
        jm2.stop()


# ------------------------------------------------ job id rebinding


def test_rebound_outputs_serve_old_and_new_ids():
    """TestJobRebindServing: the outputs move to the new id, and a reduce
    adopted across the restart still finds them under the old one; a
    handoff key follows its job's rebinding."""
    nr = object.__new__(NodeRunner)
    nr.lock = threading.RLock()
    nr.map_outputs = {("job_old_0001", 0): ("/p", {"attempt": "a"}),
                      ("handoff:job_old_0001", 1): ("/h", {"attempt": "r"})}
    nr._job_rebinds = {}
    nr._apply_action({"type": "recover_job", "old": "job_old_0001",
                      "new": "job_new_0001"})
    assert ("job_new_0001", 0) in nr.map_outputs
    assert ("job_old_0001", 0) not in nr.map_outputs
    assert nr._map_output_entry("job_new_0001", 0) is not None
    assert nr._map_output_entry("job_old_0001", 0) is not None
    assert nr._map_output_entry("job_other_0001", 0) is None
    assert nr._map_output_entry("job_old_0001", 9) is None
    nr.map_outputs[("handoff:job_new_0001", 2)] = ("/h2", {})
    assert nr._map_output_entry("handoff:job_old_0001", 2) == ("/h2", {})


def test_reinit_resets_the_runner():
    """The ``reinit`` action (tpumr/mapred/tasktracker.py:1247-1257): the
    runner drops its attempts and registers again with an initial
    contact; no master of either package sends it after a restart."""
    nr = object.__new__(NodeRunner)
    nr.lock = threading.RLock()
    nr.running = {"attempt_x_0001_m_000000_0": object()}
    nr.running_tasks = {"attempt_x_0001_m_000000_0": object()}
    nr._initial_contact, nr._response_id = False, 9
    nr._apply_action({"type": "reinit"})
    assert nr.running == {} and nr.running_tasks == {}
    assert nr._initial_contact is True and nr._response_id == 0


# ------------------------------------------------ runner, lost master


def _restart_on(conf, host, port):
    for _ in range(200):
        try:
            return JobMaster(conf, host=host, port=port).start()
        except OSError:
            time.sleep(0.05)
    raise AssertionError("could not bind the master's port again")


def _eventually(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_tracker_survives_restart_and_is_adopted(tmp_path):
    """TestTrackerLostMaster: a runner rides out a stop and a start on the
    same port: lost-master state while the master is down (nothing reset
    or killed), adopted on re-contact, the flag cleared."""
    conf = JobConf()
    conf.set("tpumr.history.dir", str(tmp_path))
    conf.set("tpumr.heartbeat.interval.ms", 50)
    conf.set("tpumr.tracker.expiry.ms", 60_000)
    conf.set(DEVICE_KEY, "cpu")
    m1 = JobMaster(conf).start()
    host, port = m1.address
    nr = NodeRunner(host, port, JobConf(conf), name="tt0").start()
    m2 = None
    try:
        assert _eventually(lambda: "tt0" in m1.trackers, 5)
        m1.stop()
        assert _eventually(lambda: nr.master_unreachable, 10), \
            "the runner must enter the lost-master state"
        assert nr._initial_contact is False
        m2 = _restart_on(conf, host, port)
        assert _eventually(lambda: "tt0" in m2.trackers)
        assert _eventually(lambda: not nr.master_unreachable, 5)
        assert m2.get_metrics()["trackers_adopted"] >= 1
    finally:
        nr.stop()
        if m2 is not None:
            m2.stop()


# ------------------------------------------------------------ chaos e2e


def _restart_cluster_conf(tmp_path):
    conf = JobConf()
    conf.set(DEVICE_KEY, "cpu")
    conf.set("tpumr.history.dir", str(tmp_path / "history"))
    conf.set("mapred.jobtracker.restart.recover", True)
    conf.set("mapred.jobtracker.restart.recovery.grace.ms", 800)
    conf.set("tpumr.heartbeat.interval.ms", 50)
    conf.set("tpumr.tracker.expiry.ms", 60_000)
    conf.set("tpumr.rpc.client.retries", 2)
    conf.set("tpumr.shuffle.fetch.retries.per.source", 1)
    conf.set("tpumr.shuffle.copy.backoff.ms", 10)
    conf.set("tpumr.shuffle.copy.backoff.max.ms", 100)
    conf.set("mapred.max.fetch.failures.per.map", 2)
    return conf


def _write_input(fs, path, lines=3000):
    fs.write_bytes(path, b"".join(b"w%02d x\n" % (i % 31)
                                  for i in range(lines)))


def _read_output(fs, outdir):
    return b"".join(fs.read_bytes(st.path)
                    for st in sorted(fs.list_status(outdir),
                                     key=lambda s: str(s.path))
                    if "part-" in str(st.path))


def _submit_wordcount(cluster, inpath, outdir, slow_map=None):
    conf = cluster.create_job_conf()
    conf.set_input_paths(inpath)
    conf.set_output_path(outdir)
    conf.set("mapred.mapper.class", "tpumr_torch.mapred.lib.TokenCountMapper")
    conf.set("mapred.reducer.class",
             "tpumr_torch.examples.basic.LongSumReducer")
    conf.set("mapred.map.tasks", 6)
    conf.set_num_reduce_tasks(2)
    conf.set("mapred.reduce.slowstart.completed.maps", 1.0)
    conf.set("mapred.speculative.execution", False)
    if slow_map is not None:
        # a straggler holds the job open across the restart
        conf.set(f"tpumr.fi.task.slow.m{slow_map}.probability", 1.0)
        conf.set(f"tpumr.fi.task.slow.m{slow_map}.max.failures", 1)
        conf.set("tpumr.fi.task.slow.ms", 1000)
    client = JobClient(conf)
    return client, client.submit_job(conf)


def _poll_status(running, deadline_s=60.0):
    """A status poll that rides out the restart window."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            return running.status()
        except Exception:  # noqa: BLE001 — the master is restarting
            time.sleep(0.05)
    raise TimeoutError("the master never answered a status poll")


def _wait_maps(running, n, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        st = _poll_status(running)
        if st["finished_maps"] >= n:
            return st
        time.sleep(0.005)
    raise TimeoutError(f"never reached {n} finished maps")


def _wait_terminal(running, deadline_s=90.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        st = _poll_status(running)
        if st["state"] in ("SUCCEEDED", "FAILED", "KILLED"):
            return st
        time.sleep(0.05)
    raise TimeoutError("the job never finished")


def _kill_and_restart_master(cluster):
    """tests/test_master_restart.py::_kill_and_restart_master: the master
    stopped with nothing finalised, a new one on the same address."""
    host, port = cluster.master.address
    cluster.master.stop()
    cluster.master = _restart_on(cluster.conf, host, port)
    return cluster.master


@pytest.fixture
def clean_fi():
    fi.reset()
    yield
    fi.reset()
    FileSystem.clear_cache()


def test_master_killed_mid_job_finishes_with_zero_map_reruns(tmp_path,
                                                             clean_fi):
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0,
                       conf=_restart_cluster_conf(tmp_path / "ctl")) as c:
        fs = FileSystem.get("mem:///", c.conf)
        _write_input(fs, "mem:///restart/in-control.txt")
        client, running = _submit_wordcount(
            c, "mem:///restart/in-control.txt", "mem:///restart/out-control")
        assert _wait_terminal(running)["state"] == "SUCCEEDED"
        client.close()
        control = _read_output(fs, "mem:///restart/out-control")
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0,
                       conf=_restart_cluster_conf(tmp_path)) as c:
        fs = FileSystem.get("mem:///", c.conf)
        _write_input(fs, "mem:///restart/in.txt")
        client, running = _submit_wordcount(
            c, "mem:///restart/in.txt", "mem:///restart/out", slow_map=5)
        old_id = running.job_id
        _wait_maps(running, 4)
        m2 = _kill_and_restart_master(c)
        st = _wait_terminal(running)
        assert st["state"] == "SUCCEEDED", st
        new_id = running.job_id
        assert new_id != old_id, "the polling client follows the new id"
        assert m2.get_recovered_jobs()[old_id] == new_id
        assert _read_output(fs, "mem:///restart/out") == control
        snap = m2.get_metrics()
        assert snap["jobs_recovered"] == 1
        assert snap["attempts_recovered"] >= 4
        assert snap["trackers_adopted"] >= 2
        assert snap["maps_launched_cpu"] == snap["maps_launched_tpu"] == 0
        assert snap["maps_reexecuted_fetch_failure"] == 0
        events = JobHistory.read(os.path.join(
            str(tmp_path / "history"), f"{new_id}.jsonl"))
        assert [e for e in events if e.get("event") == "TASK_STARTED"
                and "_m_" in str(e.get("attempt_id", ""))] == []
        winners = {t.successful_attempt for t in m2.jobs[new_id].maps}
        assert all(f"_{JobID.parse(old_id).cluster}_" in w
                   for w in winners), winners
        client.close()


def test_lost_recovered_output_reruns_exactly_that_map(tmp_path, clean_fi):
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0,
                       conf=_restart_cluster_conf(tmp_path)) as c:
        fs = FileSystem.get("mem:///", c.conf)
        _write_input(fs, "mem:///restart2/in.txt")
        client, running = _submit_wordcount(
            c, "mem:///restart2/in.txt", "mem:///restart2/out", slow_map=5)
        old_id = running.job_id
        _wait_maps(running, 4)
        m2 = _kill_and_restart_master(c)
        new_id = m2.get_recovered_jobs()[old_id]
        popped = None
        for tr in c.trackers:
            with tr.lock:
                for key in ((old_id, 0), (new_id, 0)):
                    if key in tr.map_outputs:
                        popped = tr.map_outputs.pop(key)
                        break
            if popped:
                break
        assert popped is not None, "map 0's recovered output is served"
        st = _wait_terminal(running)
        assert st["state"] == "SUCCEEDED", st
        counts = dict(line.split(b"\t") for line in
                      _read_output(fs, "mem:///restart2/out").splitlines())
        assert counts[b"x"] == b"3000" and counts[b"w00"] == b"97"
        snap = m2.get_metrics()
        assert snap["maps_reexecuted_fetch_failure"] == 1
        assert snap["maps_launched_cpu"] == 1
        assert sum(t.failures for t in m2.jobs[new_id].maps) == 1
        client.close()


# ------------------------------------- hybrid K-Means across a restart


def _write_npy(fs, path, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    fs.write_bytes(path, buf.getvalue())


def _kmeans_conf(conf, prefix, out):
    """tests/test_torch_cluster.py's hybrid job: dense splits of 25 rows,
    the kmeans-assign kernel, one reduce."""
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
    conf.set("mapred.reduce.slowstart.completed.maps", 1.0)
    return conf


def _centroids(read_bytes, path):
    got = {}
    for line in read_bytes(path).decode().splitlines():
        k, v = line.split("\t")
        got[int(k)] = np.array(ast.literal_eval(v), np.float64)
    return np.stack([got[i] for i in sorted(got)])


def test_hybrid_kmeans_survives_a_restart_as_jax_job(tmp_path, clean_fi):
    """chip_smoke.py's master_state (a) at a small size on the CPU: the
    hybrid K-Means job (8 splits, one runner with 3 CPU and 1 accelerator
    slots) loses its master once every map launched and 4 folded; the
    restarted master recovers it, launches no map, and the centroids are
    the JAX package's job's."""
    rng = np.random.default_rng(4)
    cents = rng.standard_normal(size=(3, 4)).astype(np.float32)
    pts = rng.standard_normal(size=(200, 4)).astype(np.float32)
    jfs = jax_get_filesystem("mem:///")
    _write_npy(jfs, "/hr/points.npy", pts)
    _write_npy(jfs, "/hr/cents.npy", cents)
    jax_clear_centroids()
    with JaxMiniMRCluster(num_trackers=1, cpu_slots=3, tpu_slots=1) as jc:
        jconf = _kmeans_conf(jc.create_job_conf(), "hr", "out")
        jst = JaxJobClient(jconf).submit_job(jconf).wait_for_completion(
            timeout=JOB_TIMEOUT)
    assert jst["state"] == "SUCCEEDED", jst
    want = _centroids(jfs.read_bytes, "/hr/out/part-00000")

    clear_centroid_cache()
    gpu_runner.clear_split_caches()
    conf = _restart_cluster_conf(tmp_path)
    conf.set("mapred.jobtracker.map.optionalscheduling", True)
    with MiniMRCluster(num_trackers=1, cpu_slots=3, tpu_slots=1,
                       conf=conf) as c:
        fs = FileSystem.get("mem:///", c.conf)
        _write_npy(fs, "mem:///hr/points.npy", pts)
        _write_npy(fs, "mem:///hr/cents.npy", cents)
        jconf = _kmeans_conf(c.create_job_conf(), "hr", "out")
        jconf.set("mapred.speculative.execution", False)
        jconf.set("tpumr.fi.task.slow.m7.probability", 1.0)
        jconf.set("tpumr.fi.task.slow.m7.max.failures", 1)
        jconf.set("tpumr.fi.task.slow.ms", 1000)
        client = JobClient(jconf)
        running = client.submit_job(jconf)
        old_id = running.job_id
        jip = c.master.jobs[old_id]
        assert _eventually(lambda: jip.pending_map_count() == 0
                           and jip.finished_maps >= 4, 30)
        m2 = _kill_and_restart_master(c)
        st = _wait_terminal(running)
        assert st["state"] == "SUCCEEDED", st
        assert running.job_id == m2.get_recovered_jobs()[old_id]
        snap = m2.get_metrics()
        assert snap["jobs_recovered"] == 1
        assert snap["attempts_recovered"] >= 4
        assert snap["trackers_adopted"] >= 1
        assert snap["maps_launched_cpu"] == snap["maps_launched_tpu"] == 0
        assert st["finished_maps"] == 8
        client.close()
        got = _centroids(fs.read_bytes, "mem:///hr/out/part-00000")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
