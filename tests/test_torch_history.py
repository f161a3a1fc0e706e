"""The port's job history and attempt-level recovery
(tpumr_torch.mapred.history.JobHistory, JobInProgress.recover_attempts and
adopt_running_attempt) against the JAX package's (tpumr/mapred/history.py,
tpumr/mapred/job_in_progress.py:1387-1530).

Mirrors tests/test_master_restart.py's TestHistoryAttemptReplay,
TestRecoverAttempts and TestAdoptRunningAttempt (``:45-220``): each case
runs on both packages from the same events and records and must give the
same state. A history file is also written by one package's JobHistory and
read by the other's into the same recovered state, both ways.
"""

import json
import os
import time
from types import SimpleNamespace

import pytest

import tpumr.mapred.history as jax_history
import tpumr.mapred.ids as jax_ids
import tpumr.mapred.job_in_progress as jax_jip
import tpumr.mapred.jobconf as jax_jobconf
import tpumr.mapred.task as jax_task
import tpumr_torch.mapred.history as port_history
import tpumr_torch.mapred.ids as port_ids
import tpumr_torch.mapred.job_in_progress as port_jip
import tpumr_torch.mapred.jobconf as port_jobconf
import tpumr_torch.mapred.task as port_task

JAX = SimpleNamespace(name="jax", history=jax_history, ids=jax_ids,
                      jip=jax_jip, JobConf=jax_jobconf.JobConf,
                      task=jax_task)
PORT = SimpleNamespace(name="port", history=port_history, ids=port_ids,
                       jip=port_jip, JobConf=port_jobconf.JobConf,
                       task=port_task)
PKGS = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
#: a fixed stamp for the records, so that both packages see equal input
TS = 1_000_000.0


def _history(pkg, path, **conf):
    c = pkg.JobConf()
    c.set("tpumr.history.dir", str(path))
    for k, v in conf.items():
        c.set(k, v)
    return pkg.history.JobHistory(c)


def _replay_events(h):
    """TestHistoryAttemptReplay::test_last_success_wins_and_withdrawals_
    erase's events."""
    job = "job_old_0001"
    a0 = "attempt_old_0001_m_000000_0"
    a1 = "attempt_old_0001_m_000000_1"
    b0 = "attempt_old_0001_m_000001_0"
    r0 = "attempt_old_0001_r_000000_0"
    h.task_event(job, "TASK_STARTED", attempt_id=a0, tracker="t1")
    h.task_event(job, "TASK_FINISHED", attempt_id=a0, is_map=True,
                 runtime=1.5, tracker="t1", shuffle_addr="h1:70",
                 run_on_tpu=False, counters={"G": {"C": 3}})
    h.task_event(job, "MAP_OUTPUT_LOST", attempt_id=a0, shuffle_addr="h1:70")
    h.task_event(job, "TASK_FINISHED", attempt_id=a1, is_map=True,
                 runtime=2.0, tracker="t2", shuffle_addr="h2:70",
                 run_on_tpu=True, tpu_device_id=3)
    h.task_event(job, "TASK_FINISHED", attempt_id=b0, is_map=True,
                 runtime=0.5, tracker="t1", shuffle_addr="h1:70")
    h.task_event(job, "TASK_FINISHED", attempt_id=r0, is_map=False,
                 runtime=4.0, tracker="t2")
    return job


def _without_ts(state):
    return {kind: {i: {k: v for k, v in rec.items() if k != "ts"}
                   for i, rec in recs.items()}
            for kind, recs in state.items()}


# ----------------------------------------------------- history replay


@PKGS
def test_last_success_wins_and_withdrawals_erase(pkg, tmp_path):
    h = _history(pkg, tmp_path)
    job = _replay_events(h)
    state = h.recovered_attempt_state(job)
    assert set(state["maps"]) == {0, 1}
    m0 = state["maps"][0]
    assert m0["attempt_id"] == "attempt_old_0001_m_000000_1"
    assert m0["shuffle_addr"] == "h2:70"
    assert m0["run_on_tpu"] is True and m0["tpu_device_id"] == 3
    assert state["maps"][1]["counters"] == {}
    assert state["reduces"][0]["attempt_id"] == "attempt_old_0001_r_000000_0"
    assert state["reduces"][0]["runtime"] == 4.0
    h.stop()


@PKGS
def test_withdrawn_without_rerun_is_not_recovered(pkg, tmp_path):
    h = _history(pkg, tmp_path)
    job = "job_old_0002"
    a0 = "attempt_old_0002_m_000000_0"
    h.task_event(job, "TASK_FINISHED", attempt_id=a0, is_map=True,
                 runtime=1.0, tracker="t1", shuffle_addr="h1:70")
    h.task_event(job, "MAP_OUTPUT_LOST", attempt_id=a0,
                 shuffle_addr="h1:70", reason="tracker_lost")
    assert h.recovered_attempt_state(job)["maps"] == {}
    h.stop()


@PKGS
def test_missing_history_is_empty(pkg, tmp_path):
    h = _history(pkg, tmp_path)
    assert h.recovered_attempt_state("job_never_0001") == \
        {"maps": {}, "reduces": {}}
    assert h.retired_job_status("job_never_0001") is None
    assert h.incomplete_jobs() == []


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_history_file_is_interchangeable(writer, reader, tmp_path):
    """A log written by one package's JobHistory (its async writer, then
    stop) reads in the other's into the same recovered state, the same
    incomplete-job list and the same retired status."""
    w = _history(writer, tmp_path)
    job = _replay_events(w)
    jip = writer.jip.JobInProgress(
        writer.ids.JobID("old", 1),
        {"mapred.job.name": "x", "mapred.reduce.tasks": 1},
        [{"locations": ["h1"]}, {"locations": []}])
    w.job_submitted(jip)
    w.task_event(str(jip.job_id), "JOB_PRIORITY_CHANGED", priority="HIGH",
                 by="")
    w.job_recovered("job_gone_0003", "job_new_0001")
    w.stop()
    r = _history(reader, tmp_path)
    w2 = _history(writer, tmp_path)
    assert _without_ts(r.recovered_attempt_state(job)) == \
        _without_ts(w2.recovered_attempt_state(job))
    got, want = r.incomplete_jobs(), w2.incomplete_jobs()
    assert [e["job_id"] for e in got] == [e["job_id"] for e in want] \
        == [str(jip.job_id)]
    assert got[0]["conf"] == want[0]["conf"]
    assert got[0]["conf"]["mapred.job.priority"] == "HIGH"
    assert got[0]["splits"] == want[0]["splits"]
    assert r.retired_job_status("job_gone_0003") == \
        w2.retired_job_status("job_gone_0003") == \
        {"job_id": "job_gone_0003", "recovered_as": "job_new_0001"}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_finished_job_status_and_rollup_interchangeable(writer, reader,
                                                        tmp_path):
    """JOB_FINISHED and the stats rollup of a finished job, written by one
    package, served the same by the other."""
    w = _history(writer, tmp_path, **{"tpumr.history.async": False})
    jip = writer.jip.JobInProgress(
        writer.ids.JobID("fin", 1), {"mapred.reduce.tasks": 0},
        [{"locations": []}, {"locations": []}])
    w.job_submitted(jip)
    for t in (jip.obtain_new_map_task("h", run_on_tpu=i == 0)
              for i in range(2)):
        jip.update_task_status(writer.task.TaskStatus(
            attempt_id=t.attempt_id, is_map=True,
            state=writer.task.TaskState.SUCCEEDED, start_time=TS,
            finish_time=TS + 1 + t.partition,
            run_on_tpu=t.run_on_tpu), "h:1")
    w.job_finished(jip)
    w.write_job_metrics(jip)
    r = _history(reader, tmp_path)
    got = r.retired_job_status(str(jip.job_id))
    want = _history(writer, tmp_path).retired_job_status(str(jip.job_id))
    assert got == want
    assert got["state"] == "SUCCEEDED" and got["finished_maps"] == 2
    rollup = r.read_job_metrics(str(jip.job_id))
    assert rollup["map_latency"] == {"p50": 1.0, "p95": 2.0, "p99": 2.0,
                                     "count": 2, "mean": 1.5, "max": 2.0}
    assert rollup["finished_tpu_maps"] == rollup["finished_cpu_maps"] == 1


@PKGS
def test_async_writer_flushes_bounds_and_stops(pkg, tmp_path):
    """The writer's queue: flush waits for the disk, a full queue drops
    and counts, an event after stop is written at once."""
    h = _history(pkg, tmp_path, **{"tpumr.history.queue.max": 5})
    with h._cv:   # hold the writer so that the queue fills
        for i in range(8):
            h._write("job_q_0001", {"event": "E", "i": i})
    assert h.writes_dropped == 3
    assert h.flush() is True
    h.stop()
    h.task_event("job_q_0001", "LATE")
    events = h.read(os.path.join(tmp_path, "job_q_0001.jsonl"))
    assert [e.get("i") for e in events] == [0, 1, 2, 3, 4, None]
    assert events[-1]["event"] == "LATE"


# -------------------------------------------------- JIP attempt replay


def _jip(pkg, n_maps=3, n_reduces=1, **conf):
    base = {"mapred.reduce.tasks": n_reduces,
            "mapred.reduce.slowstart.completed.maps": 0.0}
    base.update(conf)
    return pkg.jip.JobInProgress(pkg.ids.JobID("new", 1), base,
                                 [{"locations": []} for _ in range(n_maps)])


def _map_rec(task=0, attempt=0, addr="h1:70", runtime=1.0, on_tpu=False):
    return {"attempt_id": f"attempt_old_0001_m_{task:06d}_{attempt}",
            "attempt": attempt, "is_map": True, "runtime": runtime,
            "tracker": "t1", "shuffle_addr": addr, "run_on_tpu": on_tpu,
            "tpu_device_id": -1, "counters": {"G": {"C": 2}}, "ts": TS}


def _jip_view(jip):
    return {"finished_maps": jip.finished_maps,
            "finished_cpu_maps": jip.finished_cpu_maps,
            "finished_tpu_maps": jip.finished_tpu_maps,
            "pending": jip.pending_map_count(),
            "states": [t.state for t in jip.maps + jip.reduces],
            "winners": [t.successful_attempt for t in jip.maps],
            "next": [t.next_attempt for t in jip.maps],
            "events": [dict(e) for e in jip.completion_events],
            "state": jip.state, "recovered_from": jip.recovered_from,
            "counters": jip.counters.to_dict(),
            "factor": jip.acceleration_factor()}


def _both_jips(n_maps, n_reduces, state, **conf):
    out = []
    for pkg in (JAX, PORT):
        jip = _jip(pkg, n_maps, n_reduces, **conf)
        n = jip.recover_attempts(state, "job_old_0001")
        out.append((jip, n))
    (j, nj), (p, np_) = out
    assert np_ == nj
    assert _jip_view(p) == _jip_view(j)
    return p, np_


def test_completed_maps_adopted_with_events():
    jip, n = _both_jips(3, 2, {"maps": {0: _map_rec(task=0),
                                        1: _map_rec(task=1, addr="")},
                               "reduces": {}})
    # map 1 had no serving address: a job with reduces runs it again
    assert n == 1
    assert jip.recovered_from == "job_old_0001"
    assert jip.finished_maps == 1 and jip.finished_cpu_maps == 1
    assert jip.pending_map_count() == 2
    assert jip.maps[0].successful_attempt == "attempt_old_0001_m_000000_0"
    assert jip.maps[0].next_attempt == 1
    events, _ = jip.completion_events.read(0, 100)
    assert [(e["map_index"], e["shuffle_addr"]) for e in events] == \
        [(0, "h1:70")]
    assert "attempt_old_0001_m_000000_0" in jip.history_logged


def test_no_reduce_job_recovers_without_address():
    jip, n = _both_jips(1, 0, {"maps": {0: _map_rec(addr="")},
                               "reduces": {}})
    assert n == 1 and jip.finished_maps == 1
    assert list(jip.completion_events) == []


def test_fully_complete_job_recovers_terminal():
    rrec = dict(_map_rec(task=0), is_map=False,
                attempt_id="attempt_old_0001_r_000000_0")
    jip, n = _both_jips(1, 1, {"maps": {0: _map_rec(task=0)},
                               "reduces": {0: rrec}})
    assert n == 2 and jip.state == "SUCCEEDED"


def test_profile_sums_recovered_per_backend():
    jip, _ = _both_jips(2, 1, {"maps": {0: _map_rec(task=0, runtime=2.0),
                                        1: _map_rec(task=1, runtime=1.0,
                                                    on_tpu=True)},
                               "reduces": {}})
    assert jip.cpu_map_mean_time() == 2.0
    assert jip.tpu_map_mean_time() == 1.0
    assert jip.acceleration_factor() == 2.0


def test_recovered_reduce_reports_count_as_this_jobs():
    """A reduce attempt adopted from the old job reports a lost output
    under the old job id: the recovered job counts it."""
    out = []
    for pkg in (JAX, PORT):
        jip = _jip(pkg, 1, 1)
        jip.recover_attempts({"maps": {0: _map_rec()}, "reduces": {}},
                             "job_old_0001")
        red = pkg.task.TaskStatus(
            attempt_id=pkg.ids.TaskAttemptID.parse(
                "attempt_old_0001_r_000000_0"),
            is_map=False, state=pkg.task.TaskState.RUNNING)
        assert jip.adopt_running_attempt(red) is True
        out.append(jip.fetch_failure_notification(
            "attempt_old_0001_m_000000_0", "attempt_old_0001_r_000000_0"))
    assert out[0] == out[1]
    assert out[1]["withdrawn"] and out[1]["reexecuted"]


# ---------------------------------------------------- adopting attempts


def _running_status(pkg, task=0, attempt=0):
    return pkg.task.TaskStatus(
        attempt_id=pkg.ids.TaskAttemptID.parse(
            f"attempt_old_0001_m_{task:06d}_{attempt}"),
        is_map=True, state=pkg.task.TaskState.RUNNING, progress=0.4,
        phase=pkg.task.TaskPhase.MAP)


@PKGS
def test_pending_tip_adopts_and_leaves_pending_set(pkg):
    jip = _jip(pkg, n_maps=2)
    st = _running_status(pkg, task=0)
    assert jip.adopt_running_attempt(st) is True
    assert jip.pending_map_count() == 1
    assert jip.maps[0].state == "running"
    done = pkg.task.TaskStatus(attempt_id=st.attempt_id, is_map=True,
                               state=pkg.task.TaskState.SUCCEEDED,
                               progress=1.0, finish_time=time.time())
    jip.update_task_status(done, "h1:70")
    assert jip.finished_maps == 1
    assert jip.maps[0].successful_attempt == str(st.attempt_id)


@PKGS
def test_succeeded_tip_rejects_unknown_twin(pkg):
    jip = _jip(pkg, n_maps=1)
    jip.recover_attempts({"maps": {0: _map_rec(task=0)}, "reduces": {}},
                         "job_old_0001")
    assert jip.adopt_running_attempt(
        _running_status(pkg, task=0, attempt=3)) is False
    assert jip.adopt_running_attempt(_running_status(pkg, task=0)) is True


@PKGS
def test_terminal_job_rejects(pkg):
    jip = _jip(pkg, n_maps=1)
    jip.kill()
    assert jip.adopt_running_attempt(_running_status(pkg)) is False


@PKGS
def test_unknown_task_index_rejects(pkg):
    jip = _jip(pkg, n_maps=1)
    assert jip.adopt_running_attempt(_running_status(pkg, task=7)) is False


@PKGS
def test_recovery_grace_holds_the_schedule(pkg):
    jip = _jip(pkg, n_maps=1)
    jip.schedule_hold_until = time.monotonic() + 60
    assert jip.obtain_new_map_task("h", False) is None
    assert jip.obtain_new_reduce_task("h") is None
    jip.schedule_hold_until = time.monotonic() - 1
    assert jip.obtain_new_map_task("h", False) is not None


def test_history_lines_are_json_objects(tmp_path):
    """The port's file is plain JSON lines, one object a line, each with
    its event name and stamp."""
    h = _history(PORT, tmp_path, **{"tpumr.history.async": False})
    h.task_event("job_l_0001", "TASK_STARTED", attempt_id="a", tracker="t")
    with open(os.path.join(tmp_path, "job_l_0001.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert lines == [{"event": "TASK_STARTED", "attempt_id": "a",
                      "tracker": "t", "ts": lines[0]["ts"]}]


def test_async_writer_under_concurrent_writers(tmp_path):
    """More writer threads than cores, a short switch interval: every
    event reaches the file once, each thread's in its order."""
    import sys
    import threading
    h = _history(PORT, tmp_path)
    n_threads, n_events = 16, 200

    def write(t):
        for i in range(n_events):
            h.task_event("job_c_0001", "E", t=t, i=i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert h.flush() is True
    h.stop()
    events = h.read(os.path.join(tmp_path, "job_c_0001.jsonl"))
    assert len(events) == n_threads * n_events and h.writes_dropped == 0
    for t in range(n_threads):
        assert [e["i"] for e in events if e["t"] == t] == list(range(n_events))
