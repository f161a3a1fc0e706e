"""The port's accelerator fault tolerance on its MiniMRCluster, on the CPU
(``tpumr_torch.device=cpu``: the accelerator slots run the kernels' plain
versions): demotion, the per-device quarantine and its probe, the
hung-task reaper, the node health script and the task memory manager,
and the ``sleep`` example.

Oracles: tests/test_accel_fault.py (TestEndToEndDemotionChaos, :585-656;
TestTrackerDeviceQuarantine, :377-431; TestEndToEndHungTaskReap, :657-709
and :760; TestHealthReportSurfaced, :430-456), tests/test_reliability.py
(TestNodeHealth, :213-254; TestTaskMemoryManager, :255-293), and the
local run of ``examples sleep`` for its run on the cluster. Every wait has a
timeout, and every cluster, thread and process is stopped before its test
ends.
"""

import os
import subprocess
import sys
import threading
import time
from collections import Counter

import pytest

from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.jobtracker import JobMaster as JaxJobMaster
from tpumr.mapred.node_health import NodeHealthChecker as JaxHealthChecker
from tpumr_torch.core.counters import JobCounter
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred.job_client import JobClient
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.jobtracker import JobMaster
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.mapred.node_health import (NodeHealthChecker,
                                            TaskMemoryManager)
from tpumr_torch.mapred.task import TaskState
from tpumr_torch.ops.registry import KernelMapper, register_kernel
from tpumr_torch.utils import fi

FI_SEED = "20260804"
#: seconds any one job may take here
JOB_TIMEOUT = 30
#: the word lines of every job's input, and their counts
N_LINES = 2000


def _count(batch):
    counts = Counter()
    for i in range(batch.num_records):
        counts.update(bytes(batch.value(i)).split())
    return sorted(counts.items())


class FaultCountKernel(KernelMapper):
    """tests/test_accel_fault.py's faultcount: the accelerator slot and the
    CPU slot give the same records, so a demoted job's output is the
    CPU-only run's byte for byte."""

    name = "faultcount"

    def map_batch(self, batch, conf, task):
        return _count(batch)

    map_batch_cpu = staticmethod(lambda batch, conf, task: _count(batch))


register_kernel(FaultCountKernel())


@pytest.fixture(autouse=True)
def _clean():
    fi.reset()
    yield
    fi.reset()
    FileSystem.clear_cache()


def _base(**kv) -> JobConf:
    conf = JobConf()
    conf.set(DEVICE_KEY, "cpu")
    for k, v in kv.items():
        conf.set(k, v)
    return conf


def _write_input(path: str) -> None:
    FileSystem.get(path).write_bytes(
        path, b"".join(b"w%02d x\n" % (i % 23) for i in range(N_LINES)))


def _run(cluster, inp: str, out: str, **kv):
    """The faultcount job on the cluster: 4 maps, 1 reduce. Returns the
    master's job and the job's output bytes."""
    conf = cluster.create_job_conf()
    conf.set_input_paths(inp)
    conf.set_output_path(out)
    conf.set("mapred.reducer.class", "tpumr_torch.examples.basic.LongSumReducer")
    conf.set("mapred.map.tasks", 4)
    conf.set_num_reduce_tasks(1)
    conf.set_map_kernel("faultcount")
    for k, v in kv.items():
        conf.set(k, v)
    client = JobClient(conf)
    try:
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=JOB_TIMEOUT)
    finally:
        client.close()
    assert st["state"] == "SUCCEEDED", st.get("error")
    fs = FileSystem.get(out)
    data = b"".join(fs.read_bytes(s.path) for s in sorted(
        fs.list_status(out), key=lambda s: str(s.path))
        if "part-" in str(s.path))
    return cluster.master.jobs[running.job_id], data


def _failed(jip):
    return [s for tip in jip.maps for s in tip.attempts.values()
            if s.state == TaskState.FAILED]


def _no_task_threads(cluster, timeout=5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(t.metrics()["task_threads"] for t in cluster.trackers):
            return True
        time.sleep(0.05)
    return False


def test_persistent_device_faults_complete_through_demotion():
    """TestEndToEndDemotionChaos: every accelerator attempt fails at
    tpu.execute (class device); each map is demoted, the job completes
    byte-identical to a CPU-only run, TPU_DEMOTIONS > 0 and the master
    counts the demotions."""
    _write_input("mem:///af/in.txt")
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0,
                       conf=_base()) as c:
        _jip, want = _run(c, "mem:///af/in.txt", "mem:///af/out-cpu")
    assert want and b"x\t2000" in want
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=1, conf=_base(
            **{"tpumr.fi.tpu.execute.probability": 1.0,
               "tpumr.fi.seed": FI_SEED})) as c:
        jip, got = _run(c, "mem:///af/in.txt", "mem:///af/out-chaos",
                        **{"tpumr.tpu.job.quarantine.tips": 3})
        metrics = c.master.get_metrics()
    assert got == want
    assert jip.counters.value(JobCounter.GROUP, JobCounter.TPU_DEMOTIONS) > 0
    assert fi.fired("tpu.execute") > 0
    failed = _failed(jip)
    assert failed and {s.failure_class for s in failed} == {"device"}
    assert all(s.run_on_tpu for s in failed)
    assert metrics["tpu_demotions"] == jip.counters.value(
        JobCounter.GROUP, JobCounter.TPU_DEMOTIONS)
    assert jip.status_dict()["finished_cpu_maps"] == 4


def test_quarantine_shrinks_the_slots_and_the_probe_restores_them():
    """TestTrackerDeviceQuarantine: two failures in a row on device 1 take
    it out of the runner's status and the master's slots; the probe
    brings it back."""
    with MiniMRCluster(num_trackers=1, cpu_slots=1, tpu_slots=2,
                       tpu_devices_per_tracker=2, conf=_base(**{
                           "tpumr.tpu.device.quarantine.failures": 2})) as c:
        tracker = c.trackers[0]
        dh = tracker.device_health
        assert dh is not None and dh.threshold == 2
        sick = [True]

        def probe(d):
            if sick[0]:
                raise RuntimeError("injected device fault")

        dh.probe = probe
        dh.record_failure(1)
        assert dh.record_failure(1)
        st = tracker._status_dict()
        assert st["max_tpu_map_slots"] == 1
        assert st["quarantined_tpu_devices"] == [1]
        assert st["available_tpu_devices"][1] is False
        deadline = time.monotonic() + 5
        while c.master.get_metrics()["tpu_devices_quarantined"] != 1:
            assert time.monotonic() < deadline, "the master never saw it"
            time.sleep(0.05)
        assert c.master.total_slots()["tpu"] == 1
        sick[0] = False
        at, _ = dh._quarantined[1]
        assert dh.probe_once(now=at) == [1]
        st = tracker._status_dict()
        assert st["max_tpu_map_slots"] == 2
        assert st["quarantined_tpu_devices"] == []
        assert st["available_tpu_devices"][1] is True


def test_faulted_card_is_quarantined_then_restored_by_its_probe():
    """The chip's quarantine step at the CPU's size, on a runner with one
    accelerator slot and no CPU slot: three device faults on card 0
    (tpu.execute.d0, at most 3), no demotion (retries 4), so the runner
    advertises 0 accelerator slots until its probe (every 100 ms) restores
    the card, and every map then finishes on it."""
    quarantined_at = []
    with MiniMRCluster(num_trackers=1, cpu_slots=0, tpu_slots=1, conf=_base(
            **{"tpumr.tpu.device.probe.interval.ms": 100})) as c:
        tracker = c.trackers[0]
        record = tracker.device_health.record_failure

        def recorded(d):
            newly = record(d)
            if newly:
                quarantined_at.append(
                    tracker._status_dict()["max_tpu_map_slots"])
            return newly

        tracker.device_health.record_failure = recorded
        _write_input("mem:///dq/in.txt")
        jip, got = _run(c, "mem:///dq/in.txt", "mem:///dq/out", **{
            "tpumr.fi.tpu.execute.d0.probability": 1.0,
            "tpumr.fi.tpu.execute.d0.max.failures": 3,
            "tpumr.tpu.attempt.retries": 4,
            "tpumr.tpu.job.quarantine.tips": 100})
        restores = tracker.device_health.restore_events
        assert _no_task_threads(c)
    assert quarantined_at == [0] and restores == 1
    assert fi.fired("tpu.execute.d0") == 3
    assert [s.failure_class for s in _failed(jip)] == ["device"] * 3
    assert jip.counters.value(JobCounter.GROUP, JobCounter.TPU_DEMOTIONS) == 0
    assert jip.status_dict()["finished_tpu_maps"] == 4
    assert b"x\t2000" in got


def test_hung_map_is_reaped_and_the_job_completes():
    """TestEndToEndHungTaskReap::test_hung_map_is_reaped_and_job_completes
    at mapred.task.timeout = 1,000 ms: one attempt FAILED class timeout, not
    before its timeout, counted once in the job, the master and the runner;
    its thread ends."""
    _write_input("mem:///reap/in.txt")
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0, conf=_base(
            **{"mapred.task.timeout": 1000,
               "tpumr.fi.task.hang.m0.probability": 1.0,
               "tpumr.fi.task.hang.m0.max.failures": 1,
               "tpumr.fi.seed": FI_SEED})) as c:
        jip, got = _run(c, "mem:///reap/in.txt", "mem:///reap/out")
        metrics = c.master.get_metrics()
        reaped_by = [t.metrics()["tasks_reaped_timeout"] for t in c.trackers]
        assert _no_task_threads(c)
    assert b"x\t2000" in got and fi.fired("task.hang.m0") == 1
    reaped = _failed(jip)
    assert len(reaped) == 1 and reaped[0].failure_class == "timeout"
    assert "failed to report status" in reaped[0].diagnostics
    assert reaped[0].finish_time - reaped[0].start_time >= 1.0
    assert metrics["tasks_reaped_timeout"] == 1 and sum(reaped_by) == 1
    assert jip.counters.value(JobCounter.GROUP,
                              JobCounter.TASKS_REAPED_TIMEOUT) == 1
    assert sum(t.failures for t in jip.maps) == 1
    assert jip.maps[0].successful_attempt.endswith("_1")


def test_healthy_tasks_survive_a_tight_timeout():
    """TestEndToEndHungTaskReap::test_healthy_tasks_survive_a_tight_timeout,
    at its 1,500 ms: far above the milliseconds each map takes, and far
    below the 600 s default."""
    _write_input("mem:///ok/in.txt")
    with MiniMRCluster(num_trackers=1, cpu_slots=4, tpu_slots=0,
                       conf=_base(**{"mapred.task.timeout": 1500})) as c:
        jip, got = _run(c, "mem:///ok/in.txt", "mem:///ok/out")
        assert c.master.get_metrics()["tasks_reaped_timeout"] == 0
    assert b"x\t2000" in got and not _failed(jip)


def _sleep_outputs(root: str) -> dict:
    out = os.path.join(root, "out")
    return {n: open(os.path.join(out, n), "rb").read()
            for n in sorted(os.listdir(out)) if n.startswith("part-")}


def test_sleep_hang_map_is_reaped_on_the_cluster(tmp_path):
    """examples sleep on the cluster with --tpu --hang-map 0: map 0's first
    attempt hangs on whichever slot takes it, is reaped at the 1,000 ms
    timeout, and its attempt 1 completes the job with the local run's part
    files (tests/test_torch_accel_fault.py holds those against the JAX
    package's); no task thread stays."""
    from tpumr_torch.examples import main as examples_main
    args = ["-m", "3", "-r", "1", "--map-ms", "20", "--reduce-ms", "10"]
    assert examples_main(["sleep", *args, "--work", f"file://{tmp_path}/local",
                          "-D", "tpumr_torch.device=cpu"]) == 0
    with MiniMRCluster(num_trackers=1, cpu_slots=1, tpu_slots=1,
                       conf=_base()) as c:
        rc = examples_main([
            "sleep", *args, "--tpu", "--hang-map", "0",
            "--work", f"file://{tmp_path}/cluster",
            "-D", f"mapred.job.tracker={c.master_address}",
            "-D", "mapred.task.timeout=1000"])
        (jip,) = c.master.jobs.values()
        assert _no_task_threads(c)
        metrics = c.master.get_metrics()
    assert rc == 0
    assert _sleep_outputs(str(tmp_path / "cluster")) == \
        _sleep_outputs(str(tmp_path / "local"))
    reaped = _failed(jip)
    assert [(s.failure_class, str(s.attempt_id).endswith("_0"))
            for s in reaped] == [("timeout", True)]
    assert jip.maps[0].successful_attempt.endswith("_1")
    assert metrics["tasks_reaped_timeout"] == 1


def test_health_scripts_as_jax():
    """TestNodeHealth::test_healthy_and_error_scripts, in both packages."""
    for cls in (JaxHealthChecker, NodeHealthChecker):
        got = []
        for script in ("echo all good", "echo ERROR disk full", "exit 3"):
            hc = cls(script)
            hc.check_once()
            got.append((hc.healthy, hc.report))
        assert got == [(True, ""), (False, "ERROR disk full"), (True, "")]


def test_unhealthy_tracker_gets_no_tasks(tmp_path):
    """TestNodeHealth::test_unhealthy_tracker_gets_no_tasks: a runner whose
    script prints an ERROR line takes no map over ten heartbeats with the
    job pending; its status says why."""
    script = tmp_path / "health.sh"
    script.write_text("echo ERROR synthetic\n")
    script.chmod(0o755)
    _write_input("mem:///nh/in.txt")
    with MiniMRCluster(num_trackers=1, cpu_slots=1, tpu_slots=0, conf=_base(
            **{"mapred.healthChecker.script.path": str(script),
               "mapred.healthChecker.interval.ms": 100})) as c:
        conf = c.create_job_conf()
        conf.set_input_paths("mem:///nh/in.txt")
        conf.set_output_path("mem:///nh/out")
        conf.set_map_kernel("faultcount")
        conf.set_num_reduce_tasks(0)
        client = JobClient(conf)
        try:
            running = client.submit_job(conf)
            tracker = c.trackers[0]
            first, deadline = tracker._beats, time.monotonic() + 10
            while tracker._beats < first + 10:
                assert time.monotonic() < deadline, "the runner stopped"
                time.sleep(0.02)
            assert c.master.get_active_trackers() == [
                "tracker_0\tUNHEALTHY: ERROR synthetic"]
            assert running.status()["map_progress"] == 0.0
            assert not c.master.jobs[running.job_id].maps[0].attempts
            running.kill()
        finally:
            client.close()


def test_active_trackers_name_the_health_report_as_jax():
    """TestHealthReportSurfaced: the same two beats to both masters give
    the same active-tracker list, the sick one with its reason."""
    def beats(jm):
        for name, healthy, report in (
                ("tr_ok", True, ""),
                ("tr_sick", False, "ERROR disk full on /scratch")):
            jm.heartbeat({
                "tracker_name": name, "host": "127.0.0.1",
                "shuffle_port": 0, "max_cpu_map_slots": 1,
                "max_tpu_map_slots": 0, "max_reduce_slots": 1,
                "count_cpu_map_tasks": 0, "count_tpu_map_tasks": 0,
                "count_reduce_tasks": 0, "task_statuses": [],
                "healthy": healthy, "health_report": report}, True, False, 0)
        return jm.get_active_trackers()

    jax_jm, port_jm = JaxJobMaster(JaxJobConf()), JobMaster(JobConf())
    try:
        got = beats(port_jm)
        assert got == beats(jax_jm)
    finally:
        jax_jm.stop()
        port_jm.stop()
    assert got == ["tr_ok", "tr_sick\tUNHEALTHY: ERROR disk full on /scratch"]


def _child(code: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code])


def _sampler_threads() -> "set[threading.Thread]":
    return {t for t in threading.enumerate() if t.name == "task-memory"}


def test_memory_manager_kills_a_process_over_its_limit():
    """TestTaskMemoryManager::test_kills_over_limit_process. The JAX
    package's managers name their samplers "task-memory" too, and theirs
    never end (its TaskMemoryManager.stop only sets a flag, and its test
    of the same name never calls it): a worker that ran that test earlier
    holds one for good. So the threads alive before this test are left
    out, and every sampler this manager started must have ended."""
    before = _sampler_threads()
    proc = _child("import time\n"
                  "x = bytearray(80 * 1024 * 1024)\n"
                  "for i in range(0, len(x), 4096): x[i] = 1\n"
                  "time.sleep(30)\n")
    mm = TaskMemoryManager(interval_s=0.1)
    killed = []
    try:
        mm.register("attempt_x", proc.pid, 16 << 20,
                    lambda aid: (killed.append(aid), proc.kill()))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not killed:
            time.sleep(0.1)
        assert killed == ["attempt_x"] and mm.killed == ["attempt_x"]
        assert proc.wait(timeout=10) != 0
    finally:
        mm.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert not _sampler_threads() - before


def test_memory_manager_leaves_a_process_under_its_limit():
    """TestTaskMemoryManager::test_under_limit_untouched."""
    proc = _child("import time; time.sleep(5)")
    mm = TaskMemoryManager()
    try:
        mm.register("a", proc.pid, 1 << 30, lambda aid: proc.kill())
        assert mm.check_once() == [] and proc.poll() is None
    finally:
        mm.stop()
        proc.kill()
        proc.wait(timeout=10)
