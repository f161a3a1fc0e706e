"""Speculative execution, the remaining-work model and blacklisting on the
port (tpumr_torch.mapred.job_in_progress.JobInProgress's speculation,
tpumr_torch.mapred.jobtracker.JobMaster's fault counts and blacklist, the
``task.slow`` seam of tpumr_torch.mapred.map_task) against the JAX
package's, and the command line's admin commands through both packages.

Mirrors tests/test_reliability.py::TestSpeculativeExecution and
tests/test_feedback_scheduling.py's TestRemainingWorkModel,
TestTargetedSpeculation and TestEndToEndTargetedSpeculation: each
JobInProgress case runs on both packages from the same conf and the same
statuses, the port's twins and counts equal to the JAX package's. The
blacklist cases drive both packages' masters through the same heartbeats
(``tpumr.tracker.max.faults`` failed attempts; an output withdrawn for
fetch failures charged to the runner that served it,
tpumr/mapred/jobtracker.py:3056-3108). The CLI cases run ``job
-set-priority``, ``-kill-task``, ``-fail-task``, ``-list-attempt-ids``,
``-list-blacklisted-trackers``, ``-events`` and ``-history`` of both
command lines against their own package's master.
"""

import io
import time
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest

import tpumr.cli as jax_cli
import tpumr.mapred.ids as jax_ids
import tpumr.mapred.job_in_progress as jax_jip
import tpumr.mapred.jobconf as jax_jobconf
import tpumr.mapred.jobtracker as jax_jobtracker
import tpumr.mapred.task as jax_task
import tpumr_torch.cli as port_cli
import tpumr_torch.mapred.ids as port_ids
import tpumr_torch.mapred.job_in_progress as port_jip
import tpumr_torch.mapred.jobconf as port_jobconf
import tpumr_torch.mapred.jobtracker as port_jobtracker
import tpumr_torch.mapred.task as port_task
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred.job_client import JobClient
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.utils import fi

JAX = SimpleNamespace(name="jax", ids=jax_ids, jip=jax_jip, task=jax_task,
                      JobConf=jax_jobconf.JobConf,
                      JobMaster=jax_jobtracker.JobMaster, cli=jax_cli)
PORT = SimpleNamespace(name="port", ids=port_ids, jip=port_jip,
                       task=port_task, JobConf=port_jobconf.JobConf,
                       JobMaster=port_jobtracker.JobMaster, cli=port_cli)
PKGS = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


def _job(pkg, n_maps=2, **conf):
    base = {"mapred.reduce.tasks": 0,
            "mapred.speculative.execution": True,
            "mapred.reduce.slowstart.completed.maps": 0.0}
    base.update(conf)
    return pkg.jip.JobInProgress(pkg.ids.JobID("fb", 1), base,
                                 [{"locations": []} for _ in range(n_maps)])


def _finish(pkg, job, task, runtime=1.0, is_map=True):
    now = time.time()
    job.update_task_status(pkg.task.TaskStatus(
        attempt_id=task.attempt_id, is_map=is_map,
        state=pkg.task.TaskState.SUCCEEDED, start_time=now - runtime,
        finish_time=now), "t:0")


def _running(pkg, job, task, progress):
    job.update_task_status(pkg.task.TaskStatus(
        attempt_id=task.attempt_id, is_map=True,
        state=pkg.task.TaskState.RUNNING, progress=progress), "t:0")


def _counts(job):
    return (job.speculative_launched, job.speculative_won,
            job.speculative_wasted, job.speculative_in_flight(),
            job.speculative_map_tasks, job.speculative_reduce_tasks)


# ------------------------------ tests/test_reliability.py's speculation


@PKGS
def test_speculates_slow_straggler(pkg):
    job = _job(pkg, n_maps=2)
    t0 = job.obtain_new_map_task("h", run_on_tpu=False)
    t1 = job.obtain_new_map_task("h", run_on_tpu=False)
    assert job.obtain_new_map_task("h", run_on_tpu=False) is None
    _finish(pkg, job, t0, runtime=0.01)
    job.maps[t1.partition].dispatch_mono = time.monotonic() - 100
    spec = job.obtain_new_map_task("h", run_on_tpu=False)
    assert spec is not None and spec.partition == t1.partition
    assert spec.attempt_id != t1.attempt_id
    assert job.speculative_map_tasks == 1
    assert job.obtain_new_map_task("h", run_on_tpu=False) is None
    _finish(pkg, job, spec, runtime=0.01)
    assert job.should_kill_attempt(str(t1.attempt_id))
    assert not job.should_kill_attempt(str(spec.attempt_id))
    assert _counts(job) == (1, 1, 0, 0, 1, 0)


@PKGS
def test_speculates_slow_reduce_straggler(pkg):
    job = _job(pkg, n_maps=0, **{"mapred.reduce.tasks": 2})
    r0 = job.obtain_new_reduce_task("h")
    r1 = job.obtain_new_reduce_task("h")
    assert r0 is not None and r1 is not None
    assert job.obtain_new_reduce_task("h") is None
    _finish(pkg, job, r0, runtime=0.01, is_map=False)
    job.reduces[r1.partition].dispatch_mono = time.monotonic() - 100
    spec = job.obtain_new_reduce_task("h")
    assert spec is not None and spec.partition == r1.partition
    assert job.speculative_reduce_tasks == 1
    assert job.obtain_new_reduce_task("h") is None
    _finish(pkg, job, spec, runtime=0.01, is_map=False)
    assert job.should_kill_attempt(str(r1.attempt_id))
    assert not job.should_kill_attempt(str(spec.attempt_id))


@PKGS
def test_reduce_speculation_needs_completion_and_flag(pkg):
    job = _job(pkg, n_maps=0, **{"mapred.reduce.tasks": 1})
    r = job.obtain_new_reduce_task("h")
    job.reduces[r.partition].dispatch_mono = time.monotonic() - 100
    assert job.obtain_new_reduce_task("h") is None
    off = _job(pkg, n_maps=0, **{"mapred.reduce.tasks": 2,
                                 "mapred.reduce.speculative.execution":
                                     False})
    a = off.obtain_new_reduce_task("h")
    off.obtain_new_reduce_task("h")
    _finish(pkg, off, a, runtime=0.01, is_map=False)
    off.reduces[1].dispatch_mono = time.monotonic() - 100
    assert off.obtain_new_reduce_task("h") is None


@PKGS
def test_no_speculation_without_completions_or_flag(pkg):
    job = _job(pkg, n_maps=1)
    t = job.obtain_new_map_task("h", run_on_tpu=False)
    job.maps[t.partition].dispatch_mono = time.monotonic() - 100
    assert job.obtain_new_map_task("h", run_on_tpu=False) is None
    off = _job(pkg, n_maps=2, **{"mapred.speculative.execution": False})
    a = off.obtain_new_map_task("h", run_on_tpu=False)
    off.obtain_new_map_task("h", run_on_tpu=False)
    _finish(pkg, off, a, runtime=0.01)
    off.maps[1].dispatch_mono = time.monotonic() - 100
    assert off.obtain_new_map_task("h", run_on_tpu=False) is None


# ------------------------------------------------ remaining-work model


@PKGS
def test_progress_folds_into_rate_ewma(pkg):
    job = _job(pkg, n_maps=1)
    t = job.obtain_new_map_task("h", run_on_tpu=False)
    tip = job.maps[t.partition]
    _running(pkg, job, t, 0.2)
    time.sleep(0.02)
    _running(pkg, job, t, 0.6)
    assert tip.rate_ewma > 0.0 and tip.last_progress == 0.6
    ewma = tip.rate_ewma
    _running(pkg, job, t, 0.5)
    assert tip.last_progress == 0.6 and tip.rate_ewma == ewma


def test_remaining_estimate_matches_jax():
    """The same task states give the same estimates in both packages."""
    now = time.monotonic()
    for rate, progress, age, hint in ((0.1, 0.5, 0.0, 99.0),
                                      (0.0, 0.25, 30.0, 99.0),
                                      (0.0, 0.0, 30.0, 7.0)):
        got = []
        for pkg in (JAX, PORT):
            job = _job(pkg, n_maps=1)
            t = job.obtain_new_map_task("h", run_on_tpu=False)
            tip = job.maps[t.partition]
            tip.rate_ewma, tip.last_progress = rate, progress
            tip.dispatch_mono = now - age
            got.append(job._tip_remaining_s(tip, now, hint))
        assert got[0] == pytest.approx(got[1])
    assert got[1] == 7.0   # a silent task looks long


@PKGS
def test_critical_path_and_longest_path(pkg):
    job = _job(pkg, n_maps=3)
    ts = [job.obtain_new_map_task("h", run_on_tpu=False) for _ in range(3)]
    fast, slow, mid = (job.maps[t.partition] for t in ts)
    fast.rate_ewma, fast.last_progress = 1.0, 0.9
    slow.rate_ewma, slow.last_progress = 0.01, 0.1
    mid.rate_ewma, mid.last_progress = 0.01, 0.2
    cp = job.critical_path_maps()
    assert slow.partition in cp and mid.partition in cp
    assert fast.partition not in cp
    est = job.map_remaining_estimates()
    assert len(est) == 3
    assert job.longest_remaining_path_s() == pytest.approx(
        est[slow.partition], rel=0.05)
    sd = job.status_dict()
    assert sd["longest_remaining_path_s"] > 0
    assert sd["speculative_in_flight"] == 0


# ------------------------------------------------ targeted speculation


@PKGS
def test_targets_the_critical_straggler_not_the_nearly_done(pkg):
    job = _job(pkg, n_maps=3, **{"tpumr.speculative.cap": 1})
    t0 = job.obtain_new_map_task("h", run_on_tpu=False)
    near = job.obtain_new_map_task("h", run_on_tpu=False)
    stuck = job.obtain_new_map_task("h", run_on_tpu=False)
    _finish(pkg, job, t0, runtime=1.0)
    for t in (near, stuck):
        job.maps[t.partition].dispatch_mono = time.monotonic() - 100
    job.maps[near.partition].rate_ewma = 1.0
    job.maps[near.partition].last_progress = 0.99
    spec = job.obtain_new_map_task("h", run_on_tpu=False)
    assert spec is not None and spec.partition == stuck.partition
    assert job.speculative_launched == 1
    assert job.speculative_in_flight() == 1
    assert job.obtain_new_map_task("h", run_on_tpu=False) is None
    _finish(pkg, job, spec, runtime=0.01)
    assert job.should_kill_attempt(str(stuck.attempt_id))
    assert _counts(job)[:4] == (1, 1, 0, 0)


@PKGS
@pytest.mark.parametrize("targeted", [True, False])
def test_young_task_never_speculated(pkg, targeted):
    job = _job(pkg, n_maps=2, **{"tpumr.speculative.targeted": targeted})
    a = job.obtain_new_map_task("h", run_on_tpu=False)
    job.obtain_new_map_task("h", run_on_tpu=False)
    _finish(pkg, job, a, runtime=0.01)
    assert job.obtain_new_map_task("h", run_on_tpu=False) is None
    assert job.speculative_launched == 0


@PKGS
def test_within_distribution_estimate_not_speculated(pkg):
    job = _job(pkg, n_maps=2, **{"mapred.speculative.min.runtime.s": 0.0})
    a = job.obtain_new_map_task("h", run_on_tpu=False)
    b = job.obtain_new_map_task("h", run_on_tpu=False)
    _finish(pkg, job, a, runtime=5.0)
    tip = job.maps[b.partition]
    tip.dispatch_mono = time.monotonic() - 1.0
    tip.rate_ewma, tip.last_progress = 1.0, 0.8
    assert job.obtain_new_map_task("h", run_on_tpu=False) is None
    assert job.speculative_launched == 0


@PKGS
def test_cap_bounds_concurrent_twins_blanket_does_not(pkg):
    def straggling_job(**extra):
        job = _job(pkg, n_maps=3, **extra)
        t0 = job.obtain_new_map_task("h", run_on_tpu=False)
        s1 = job.obtain_new_map_task("h", run_on_tpu=False)
        s2 = job.obtain_new_map_task("h", run_on_tpu=False)
        _finish(pkg, job, t0, runtime=0.5)
        for t in (s1, s2):
            job.maps[t.partition].dispatch_mono = time.monotonic() - 100
        return job

    capped = straggling_job(**{"tpumr.speculative.cap": 1})
    assert capped.obtain_new_map_task("h", run_on_tpu=False) is not None
    assert capped.obtain_new_map_task("h", run_on_tpu=False) is None
    assert capped.speculative_launched == 1
    blanket = straggling_job(**{"tpumr.speculative.targeted": False})
    assert blanket.obtain_new_map_task("h", run_on_tpu=False) is not None
    assert blanket.obtain_new_map_task("h", run_on_tpu=False) is not None
    assert blanket.speculative_launched == 2


@PKGS
def test_wasted_twin_counted(pkg):
    job = _job(pkg, n_maps=2)
    t0 = job.obtain_new_map_task("h", run_on_tpu=False)
    slow = job.obtain_new_map_task("h", run_on_tpu=False)
    _finish(pkg, job, t0, runtime=0.01)
    job.maps[slow.partition].dispatch_mono = time.monotonic() - 100
    spec = job.obtain_new_map_task("h", run_on_tpu=False)
    assert spec is not None
    _finish(pkg, job, slow, runtime=0.01)
    assert job.should_kill_attempt(str(spec.attempt_id))
    now = time.time()
    job.update_task_status(pkg.task.TaskStatus(
        attempt_id=spec.attempt_id, is_map=True,
        state=pkg.task.TaskState.KILLED, start_time=now, finish_time=now),
        "t:0")
    assert _counts(job)[:4] == (1, 0, 1, 0)


@PKGS
def test_demoted_maps_twin_stays_off_the_accelerator(pkg):
    """A map pinned to the CPU slots gets no twin on an accelerator slot
    (tpumr/mapred/job_in_progress.py:757-758)."""
    job = _job(pkg, n_maps=2, **{"tpumr.map.kernel": "k"})
    a = job.obtain_new_map_task("h", run_on_tpu=False)
    b = job.obtain_new_map_task("h", run_on_tpu=False)
    _finish(pkg, job, a, runtime=0.01)
    job._cpu_only_maps.add(b.partition)
    job.maps[b.partition].dispatch_mono = time.monotonic() - 100
    assert job.obtain_new_map_task("h", run_on_tpu=True,
                                   tpu_device_id=0) is None
    spec = job.obtain_new_map_task("h", run_on_tpu=False)
    assert spec is not None and not spec.run_on_tpu


# ------------------------------------------------ straggler e2e


def _write_input(fs, path, n=2000):
    fs.write_bytes(path, b"".join(b"w%02d x\n" % (i % 23)
                                  for i in range(n)))


def _output_bytes(fs, out_dir):
    return b"".join(fs.read_bytes(st.path)
                    for st in sorted(fs.list_status(out_dir),
                                     key=lambda s: str(s.path))
                    if "part-" in str(st.path))


def test_slow_map_gets_exactly_one_targeted_twin():
    """TestEndToEndTargetedSpeculation: a task.slow straggler is the one
    task twinned, the twin wins well before the crawl would end, and the
    output is right."""
    fi.reset()
    base = port_jobconf.JobConf()
    base.set(DEVICE_KEY, "cpu")
    base.set("tpumr.heartbeat.interval.ms", 100)
    base.set("tpumr.fi.seed", "20260804")
    try:
        with MiniMRCluster(num_trackers=2, conf=base, cpu_slots=2,
                           tpu_slots=0) as c:
            fs = FileSystem.get("mem:///", c.conf)
            _write_input(fs, "mem:///straggle/in.txt")
            conf = c.create_job_conf()
            conf.set_input_paths("mem:///straggle/in.txt")
            conf.set_output_path("mem:///straggle/out")
            conf.set("mapred.mapper.class",
                     "tpumr_torch.mapred.lib.TokenCountMapper")
            conf.set("mapred.reducer.class",
                     "tpumr_torch.examples.basic.LongSumReducer")
            conf.set("mapred.map.tasks", 4)
            conf.set_num_reduce_tasks(1)
            conf.set("tpumr.fi.task.slow.m0.probability", 1.0)
            conf.set("tpumr.fi.task.slow.m0.max.failures", 1)
            conf.set("tpumr.fi.task.slow.ms", 8000)
            conf.set("mapred.speculative.min.runtime.s", 0.3)
            client = JobClient(conf)
            try:
                t0 = time.monotonic()
                result = client.run_job(conf)
                wall = time.monotonic() - t0
            finally:
                client.close()
            assert result.successful
            counts = dict(line.split(b"\t") for line in _output_bytes(
                fs, "mem:///straggle/out").splitlines())
            assert counts[b"x"] == b"2000"
            assert fi.fired("task.slow.m0") == 1
            jip = c.master.jobs[str(result.job_id)]
            assert jip.maps[0].next_attempt == 2
            assert all(t.next_attempt == 1 for t in jip.maps[1:])
            assert _counts(jip)[:4] == (1, 1, 0, 0)
            assert jip.status_dict()["speculative_launched"] == 1
            assert wall < 8.0, f"the twin should rescue the job: {wall:.1f}s"
    finally:
        fi.reset()
        FileSystem.clear_cache()


# ------------------------------------------------ blacklisting


def _status(name, host, port, statuses=(), cpu=2):
    return {"tracker_name": name, "host": host,
            "shuffle_addr": f"{host}:{port}", "shuffle_port": port,
            "max_cpu_map_slots": cpu, "max_tpu_map_slots": 0,
            "max_reduce_slots": 1, "count_cpu_map_tasks": 0,
            "count_tpu_map_tasks": 0, "count_reduce_tasks": 0,
            "available_tpu_devices": [], "available_memory_mb": -1,
            "task_statuses": [dict(s) for s in statuses],
            "fetch_failures": [], "healthy": True, "health_report": ""}


def _sd(pkg, aid, state, runtime=0.1):
    now = time.time()
    return {"attempt_id": aid, "is_map": "_m_" in aid, "state": state,
            "progress": 1.0 if state == "SUCCEEDED" else 0.5,
            "phase": "MAP" if "_m_" in aid else "REDUCE",
            "start_time": now - runtime, "finish_time": now,
            "diagnostics": "boom" if state == "FAILED" else "",
            "counters": {}, "run_on_tpu": False, "tpu_device_id": -1,
            "failure_class": ""}


def _launched(resp):
    return [a["task"]["attempt_id"] for a in resp["actions"]
            if a["type"] == "launch"]


def _master(pkg, **keys):
    conf = pkg.JobConf()
    conf.set("tpumr.tracker.max.faults", 2)
    for k, v in keys.items():
        conf.set(k, v)
    return pkg.JobMaster(conf).start()


@PKGS
def test_runner_blacklisted_at_max_faults(pkg):
    """Two FAILED attempts on one runner (``tpumr.tracker.max.faults`` 2):
    it is blacklisted, named by get_blacklisted_trackers, left out of the
    active list, and given no task; the other runner gets the work."""
    m = _master(pkg)
    try:
        m.submit_job({"mapred.reduce.tasks": 0, "mapred.map.max.attempts": 9,
                      "mapred.speculative.execution": False},
                     [{"locations": []} for _ in range(2)])
        r = m.heartbeat(_status("bad", "h1", 71), True, True, 0)
        aids = _launched(r)
        assert len(aids) == 2
        r = m.heartbeat(_status("bad", "h1", 71, [
            _sd(pkg, a, "FAILED") for a in aids]), False, True,
            r["response_id"])
        assert _launched(r) == []
        assert m.get_blacklisted_trackers() == ["bad"]
        assert "bad" not in m.get_active_trackers()
        r2 = m.heartbeat(_status("good", "h2", 72), True, True, 0)
        assert len(_launched(r2)) == 2
        assert m.get_blacklisted_trackers() == ["bad"]
    finally:
        m.stop()


@PKGS
def test_lost_output_charged_to_the_runner_that_served_it(pkg):
    """An output withdrawn for fetch failures is a fault of the runner
    that served it, not of the reporting one: two such losses blacklist
    the server."""
    m = _master(pkg, **{"tpumr.tracker.expiry.ms": 60_000})
    try:
        jid = m.submit_job({"mapred.reduce.tasks": 1,
                            "mapred.reduce.slowstart.completed.maps": 1.0,
                            "mapred.max.fetch.failures.per.map": 1,
                            "mapred.map.max.attempts": 9,
                            "mapred.speculative.execution": False},
                           [{"locations": []} for _ in range(2)])
        r = m.heartbeat(_status("srv", "h1", 71), True, True, 0)
        maps = _launched(r)
        r = m.heartbeat(_status("srv", "h1", 71, [
            _sd(pkg, a, "SUCCEEDED") for a in maps], cpu=0),
            False, True, r["response_id"])
        red = _launched(r)
        assert len(red) == 1 and "_r_" in red[0]
        rr = m.heartbeat(_status("red", "h2", 72, cpu=0), True, False, 0)
        for i, mid in enumerate(maps):
            st = _status("red", "h2", 72, cpu=0)
            st["fetch_failures"] = [{"map_attempt": mid,
                                     "reduce_attempt": red[0]}]
            # the reduce runs on "red" as far as the master knows
            st["task_statuses"] = [_sd(pkg, red[0], "RUNNING")]
            rr = m.heartbeat(st, False, False, rr["response_id"])
        assert m.get_blacklisted_trackers() == ["srv"]
        jip = m.jobs[jid]
        assert jip.finished_maps == 0 and jip.pending_map_count() == 2
    finally:
        m.stop()


# ------------------------------------------------ the CLI's admin commands


def _run_cli(pkg, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = pkg.cli.main(argv)
    return rc, out.getvalue()


@PKGS
def test_cli_admin_commands(pkg, tmp_path):
    conf = pkg.JobConf()
    conf.set("tpumr.history.dir", str(tmp_path))
    conf.set("tpumr.tracker.max.faults", 1)
    m = pkg.JobMaster(conf).start()
    try:
        host, port = m.address
        jt = ["-jt", f"{host}:{port}"]
        jid = m.submit_job({"mapred.job.name": "adm",
                            "mapred.reduce.tasks": 1,
                            "mapred.map.max.attempts": 9,
                            "mapred.speculative.execution": False},
                           [{"locations": []} for _ in range(3)])
        r = m.heartbeat(_status("tt", "h1", 71, cpu=3), True, True, 0)
        aids = _launched(r)
        m.heartbeat(_status("tt", "h1", 71, [
            _sd(pkg, aids[0], "SUCCEEDED"), _sd(pkg, aids[1], "RUNNING"),
            _sd(pkg, aids[2], "RUNNING")]), False, False, r["response_id"])
        rc, out = _run_cli(pkg, jt + ["job", "-set-priority", jid, "high"])
        assert rc == 0 and out.strip().endswith("to HIGH")
        assert m.jobs[jid].priority == "HIGH"
        rc, out = _run_cli(pkg, jt + ["job", "-list-attempt-ids", jid, "map",
                                      "running"])
        assert rc == 0 and out.split() == sorted(aids[1:])
        rc, out = _run_cli(pkg, jt + ["job", "-list-attempt-ids", jid, "map",
                                      "completed"])
        assert out.split() == [aids[0]]
        rc, out = _run_cli(pkg, jt + ["job", "-events", jid])
        assert rc == 0 and aids[0] in out
        rc, _ = _run_cli(pkg, jt + ["job", "-kill-task", aids[1]])
        assert rc == 0
        rc, _ = _run_cli(pkg, jt + ["job", "-fail-task", aids[2]])
        assert rc == 0
        rc, _ = _run_cli(pkg, jt + ["job", "-kill-task", aids[0]])
        assert rc == 1   # finished: nothing to kill
        r = m.heartbeat(_status("tt", "h1", 71, [
            _sd(pkg, aids[1], "RUNNING"), _sd(pkg, aids[2], "RUNNING")]),
            False, False, 1)
        r = m.heartbeat(_status("tt", "h1", 71, [
            _sd(pkg, aids[1], "RUNNING"), _sd(pkg, aids[2], "RUNNING")]),
            False, False, r["response_id"])
        kills = sorted(a["attempt_id"] for a in r["actions"]
                       if a["type"] == "kill_task")
        assert kills == sorted(aids[1:])
        r = m.heartbeat(_status("tt", "h1", 71, [
            _sd(pkg, aids[1], "KILLED"), _sd(pkg, aids[2], "KILLED")]),
            False, False, r["response_id"])
        tips = m.jobs[jid].maps
        # -kill-task requeues for free; -fail-task counts a failure
        assert (tips[1].failures, tips[2].failures) == (0, 1)
        # the runner reported KILLED: no fault charged, in either package
        rc, out = _run_cli(pkg, jt + ["job", "-list-blacklisted-trackers"])
        assert rc == 0 and out.split() == []
        rc, out = _run_cli(pkg, jt + ["job", "-list-active-trackers"])
        assert rc == 0 and out.split() == ["tt"]
        # a failed attempt is a fault: at max.faults 1 the runner is out
        r = m.heartbeat(_status("tt", "h1", 71), False, True,
                        r["response_id"])
        assert _launched(r)
        r = m.heartbeat(_status("tt", "h1", 71, [
            _sd(pkg, a, "FAILED") for a in _launched(r)]), False, False,
            r["response_id"])
        rc, out = _run_cli(pkg, jt + ["job", "-list-blacklisted-trackers"])
        assert rc == 0 and out.split() == ["tt"]
        rc, out = _run_cli(pkg, jt + ["job", "-list-active-trackers"])
        assert rc == 0 and out.split() == []
    finally:
        m.stop()
    rc, out = _run_cli(pkg, ["job", "-history", jid, str(tmp_path)])
    assert rc == 0
    assert f"Job: {jid}" in out and "State: INCOMPLETE" in out
    assert "JOB_PRIORITY_CHANGED=1" in out and "TASK_KILL_REQUESTED=2" in out
    assert "TASK_FAILED=" in out and "TASK_FINISHED=1" in out
