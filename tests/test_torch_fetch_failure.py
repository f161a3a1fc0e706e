"""The port's lost-map-output recovery ("too many fetch failures"): the
copier's penalty box and reports (tpumr_torch.mapred.shuffle_copier), the
master's counting and re-execution
(tpumr_torch.mapred.job_in_progress.JobInProgress.fetch_failure_notification),
the locator's re-resolution (tpumr_torch.mapred.tasktracker.MapLocator),
the seeded fault points (tpumr_torch.utils.fi), and the whole loop on the
port's MiniMRCluster.

Oracles: tests/test_fetch_failure.py, case for case. The notification
cases run on both packages' JobInProgress, as tests/test_torch_scheduler.py
runs the scheduler, from the same conf and the same statuses: the same
results, books and events. The seeded faults draw the JAX package's
sequence for the same seed. The end-to-end run
(TestEndToEndChaos::test_lost_map_output_recovers_without_failing_reduces)
gives the JAX package's LocalJobRunner's counts for the same job. The
port-only pin: a map re-executed for lost output goes back for any slot,
placed by the port's scheduler as the JAX package's places it (the port
keeps a map whose accelerator attempt failed on accelerator slots only;
ROADMAP.md §3). Every wait has a timeout, and the cluster is stopped before
its test ends.
"""

import threading
import time
from types import SimpleNamespace

import pytest

import tpumr.mapred.ids as jax_ids
import tpumr.mapred.job_in_progress as jax_jip
import tpumr.mapred.task as jax_task
import tpumr.mapred.tasktracker as jax_tt
import tpumr.utils.fi as jax_fi
import tpumr_torch.mapred.ids as port_ids
import tpumr_torch.mapred.job_in_progress as port_jip
import tpumr_torch.mapred.task as port_task
from test_torch_scheduler import JAX as JAX_SCHED
from test_torch_scheduler import PORT as PORT_SCHED
from test_torch_scheduler import make_scheduler, placed, tracker_status
from test_torch_shuffle import (SpillChunkSource, conf_with, make_spill,
                                records_for)
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.shuffle_copier import PenaltyBox, ShuffleCopier
from tpumr_torch.mapred.tasktracker import (OutputWithdrawn,
                                            make_map_locator)
from tpumr_torch.utils import fi

JAX = SimpleNamespace(name="jax", JobID=jax_ids.JobID,
                      TaskAttemptID=jax_ids.TaskAttemptID,
                      JobInProgress=jax_jip.JobInProgress,
                      JobState=jax_jip.JobState,
                      TaskState=jax_task.TaskState,
                      TaskStatus=jax_task.TaskStatus)
PORT = SimpleNamespace(name="port", JobID=port_ids.JobID,
                       TaskAttemptID=port_ids.TaskAttemptID,
                       JobInProgress=port_jip.JobInProgress,
                       JobState=port_jip.JobState,
                       TaskState=port_task.TaskState,
                       TaskStatus=port_task.TaskStatus)

#: the fixed clock of every completed status
T0 = 1_000_000.0


# --------------------------------------------------------------- copier


class FlakySource(SpillChunkSource):
    """tests/test_fetch_failure.py::FlakySource: map 0 cannot be fetched
    until a report arrives; then it serves from a new address, as if the
    map had re-run."""

    def __init__(self, spills):
        super().__init__(spills)
        self.addr = {m: f"t0:{m}" for m in range(len(spills))}
        self.attempts = {m: f"attempt_x_0001_m_{m:06d}_0"
                         for m in range(len(spills))}
        self.recovered = threading.Event()
        self.invalidated = []

    def addr_of(self, m):
        return self.addr.get(m, "")

    def attempt_of(self, m):
        return self.attempts.get(m, "")

    def invalidate(self, m):
        self.invalidated.append(m)
        self.addr[m] = f"t1:{m}"
        self.attempts[m] = f"attempt_x_0001_m_{m:06d}_1"
        self.recovered.set()

    def __call__(self, map_index, partition, offset):
        if map_index == 0 and not self.recovered.is_set():
            raise ConnectionError("output gone (disk lost)")
        return super().__call__(map_index, partition, offset)


class DeadSource:
    chunk_bytes = 1 << 20

    def __call__(self, m, p, o):
        raise ConnectionError("gone")


def test_copier_reports_and_resolves_again_instead_of_failing(tmp_path):
    """TestCopierRecovery::test_report_then_reresolve_instead_of_failing."""
    spills = [make_spill(records_for(100, b"m%d" % i)) for i in range(3)]
    src = FlakySource(spills)
    reports = []
    conf = conf_with(**{"tpumr.shuffle.copy.backoff.ms": 1,
                        "tpumr.shuffle.copy.backoff.max.ms": 5,
                        "tpumr.shuffle.fetch.retries.per.source": 2})
    copier = ShuffleCopier(conf, src, 3, 0, str(tmp_path),
                           on_fetch_failure=lambda m, a:
                           reports.append((m, a)))
    segs = copier.copy_all()
    assert len(segs) == 3
    assert reports == [(0, "attempt_x_0001_m_000000_0")]
    assert src.invalidated == [0]
    assert copier.fetch_failures >= 2
    assert copier.fetch_failures_reported == 1
    for s in segs:
        s.close()


@pytest.mark.parametrize("callback", [False, True])
def test_copier_gives_up_without_callback_or_at_the_ceiling(tmp_path,
                                                           callback):
    """TestCopierRecovery::test_without_callback_failure_stays_terminal
    and ::test_max_failures_ceiling_is_terminal_even_with_callback: with
    or without a report callback, ``fetch.max.failures`` failures of one
    map end the copy with the fetch's own error, reports only where there
    is a callback."""
    reports = []
    conf = conf_with(**{"tpumr.shuffle.copy.backoff.ms": 1,
                        "tpumr.shuffle.copy.backoff.max.ms": 2,
                        "tpumr.shuffle.fetch.retries.per.source": 2,
                        "tpumr.shuffle.fetch.max.failures": 5})
    copier = ShuffleCopier(conf, DeadSource(), 1, 0, str(tmp_path),
                           on_fetch_failure=(lambda m, a:
                                             reports.append(m))
                           if callback else None)
    with pytest.raises(ConnectionError):
        copier.copy_all()
    assert copier.fetch_failures == 5
    assert reports == ([0, 0] if callback else [])
    assert copier.fetch_failures_reported == len(reports)
    assert copier.ram.used == 0 and not list(tmp_path.iterdir())


def test_penalty_box_and_local_backoff_are_capped_and_jittered(tmp_path):
    """TestCopierRecovery::test_penalty_box_backoff_capped_and_jittered,
    and the copier's box built from ``tpumr.shuffle.copy.backoff[.max].ms``
    (the port has no in-line retries, so the reference's
    ::test_local_backoff_jitter_and_cap is this box's)."""
    box = PenaltyBox(base_s=1.0, cap_s=4.0)
    delays = [box.punish("t0") for _ in range(6)]
    for d, nominal in zip(delays, [1, 2, 4, 4, 4, 4]):
        assert 0.5 * nominal <= d <= nominal
    assert box.active() == 1 and box.until("t0") > time.monotonic()
    box.clear("t0")
    assert box.active() == 0 and box.punish("t0") <= 1.0
    copier = ShuffleCopier(conf_with(**{
        "tpumr.shuffle.copy.backoff.ms": 100,
        "tpumr.shuffle.copy.backoff.max.ms": 400}),
        lambda m, p, o: {}, 1, 0, str(tmp_path))
    box = copier.penalty_box
    assert (box.base_s, box.cap_s) == (0.1, 0.4)
    for nominal in [0.1, 0.2, 0.4, 0.4, 0.4]:
        assert 0.5 * nominal <= box.punish("t1") <= nominal


def test_killed_attempt_stops_the_copy(tmp_path):
    """The port's abort check: a copy whose attempt was killed ends with
    TaskKilledError, its threads joined and its spills deleted."""
    from tpumr_torch.mapred.shuffle_copier import TaskKilledError
    spills = [make_spill(records_for(50, b"m%d" % i)) for i in range(4)]
    killed = threading.Event()
    src = FlakySource(spills)   # map 0 never serves: the copy waits
    conf = conf_with(**{"tpumr.shuffle.copy.backoff.ms": 50,
                        "tpumr.shuffle.fetch.retries.per.source": 100})
    copier = ShuffleCopier(conf, src, 4, 0, str(tmp_path),
                           on_fetch_failure=lambda m, a: None,
                           abort_check=killed.is_set)
    threading.Timer(0.2, killed.set).start()
    with pytest.raises(TaskKilledError):
        copier.copy_all()
    assert copier.ram.used == 0
    assert not [n for n in (tmp_path).iterdir()]


# --------------------------------------------------------- master state


def make_job(pkg, n_maps=2, n_reduces=2, **conf):
    base = {"mapred.reduce.tasks": n_reduces,
            "mapred.speculative.execution": False,
            "mapred.reduce.slowstart.completed.maps": 0.0}
    base.update(conf)
    return pkg.JobInProgress(pkg.JobID("ff", 1), base,
                             [{"locations": []} for _ in range(n_maps)])


def finish_map(pkg, job, task, runtime=1.0, on_tpu=False, addr="t0:1"):
    job.update_task_status(pkg.TaskStatus(
        attempt_id=task.attempt_id, is_map=True, run_on_tpu=on_tpu,
        state=pkg.TaskState.SUCCEEDED, start_time=T0,
        finish_time=T0 + runtime), addr)


def running_reduce(pkg, job):
    """A reduce obtained and its RUNNING status folded: reports count
    only from reducers the master knows to be running."""
    t = job.obtain_new_reduce_task("h")
    job.update_task_status(pkg.TaskStatus(
        attempt_id=t.attempt_id, is_map=False,
        state=pkg.TaskState.RUNNING, start_time=T0), "t:0")
    return str(t.attempt_id)


def books(job):
    """What the cases compare besides their results. The JAX package's
    events also carry ``output_bytes``, the key of its size-aware fetch
    order, which the port leaves out (ROADMAP.md §1): not compared."""
    return {"state": job.state, "finished_maps": job.finished_maps,
            "finished_tpu_maps": job.finished_tpu_maps,
            "finished_cpu_maps": job.finished_cpu_maps,
            "tpu_sum": job._tpu_time_sum, "cpu_sum": job._cpu_time_sum,
            "pending_maps": job.pending_map_count(),
            "failures": [t.failures for t in job.maps],
            "successful": [t.successful_attempt for t in job.maps],
            "ff_pending": job.fetch_failure_pending_count(),
            "events": [{k: v for k, v in e.items() if k != "output_bytes"}
                       for e in job.completion_events],
            "error": job.error}


def case_distinct_reducers_until_threshold(pkg):
    job = make_job(pkg, n_maps=1, n_reduces=3,
                   **{"mapred.max.fetch.failures.per.map": 2})
    finish_map(pkg, job, job.obtain_new_map_task("h", run_on_tpu=False),
               addr="t0:9")
    aid = job.maps[0].successful_attempt
    r0, r1, r2 = (running_reduce(pkg, job) for _ in range(3))
    out = [job.fetch_failure_notification(aid, r0),
           job.fetch_failure_notification(aid, r0)]
    # a second attempt of the same reduce corroborates nothing new
    twin = pkg.TaskAttemptID(pkg.TaskAttemptID.parse(r0).task, 99)
    job.update_task_status(pkg.TaskStatus(
        attempt_id=twin, is_map=False, state=pkg.TaskState.RUNNING,
        start_time=T0), "t:0")
    out.append(job.fetch_failure_notification(aid, str(twin)))
    out.append(job.fetch_failure_pending_count())
    out.append(job.fetch_failure_notification(aid, r1))
    out.append(books(job))
    out.append(job.fetch_failure_notification(aid, r2))   # stale now
    assert out[0]["reports"] == out[2]["reports"] == 1
    assert out[4] == {"withdrawn": True, "reexecuted": True,
                      "shuffle_addr": "t0:9", "reports": 2}
    assert out[5]["pending_maps"] == 1 and out[5]["failures"] == [1]
    assert out[6] is None
    return out


def case_single_reduce_job(pkg):
    job = make_job(pkg, n_maps=1, n_reduces=1)   # threshold 3 by default
    finish_map(pkg, job, job.obtain_new_map_task("h", run_on_tpu=False))
    r0 = running_reduce(pkg, job)
    res = job.fetch_failure_notification(job.maps[0].successful_attempt,
                                         r0)
    assert res["withdrawn"] and res["reexecuted"]
    return [res, books(job)]


def case_profile_sums_unwound(pkg):
    job = make_job(pkg, n_maps=2, n_reduces=1)
    t0 = job.obtain_new_map_task("h", run_on_tpu=True, tpu_device_id=0)
    t1 = job.obtain_new_map_task("h", run_on_tpu=False)
    finish_map(pkg, job, t0, runtime=4.0, on_tpu=True)
    finish_map(pkg, job, t1, runtime=8.0)
    r0 = running_reduce(pkg, job)
    res = job.fetch_failure_notification(
        job.maps[t0.partition].successful_attempt, r0)
    b = books(job)
    assert res["withdrawn"]
    assert (b["finished_tpu_maps"], b["tpu_sum"]) == (0, 0.0)
    assert (b["finished_cpu_maps"], b["cpu_sum"]) == (1, 8.0)
    assert job.tpu_map_mean_time() == 0.0
    return [res, b]


def case_repeated_loss_fails_the_job(pkg):
    job = make_job(pkg, n_maps=1, n_reduces=1,
                   **{"mapred.map.max.attempts": 2})
    r0 = running_reduce(pkg, job)
    out = []
    for _ in range(2):
        finish_map(pkg, job, job.obtain_new_map_task("h", run_on_tpu=False))
        out.append(job.fetch_failure_notification(
            job.maps[0].successful_attempt, r0))
    out.append(books(job))
    assert out[-2]["withdrawn"] and not out[-2]["reexecuted"]
    assert job.state == pkg.JobState.FAILED
    assert "fetch failures" in job.error
    return out


def case_unknown_forged_and_finished_reporters_ignored(pkg):
    job = make_job(pkg, n_maps=1, n_reduces=2)
    r0 = running_reduce(pkg, job)
    out = [job.fetch_failure_notification("garbage", r0),
           job.fetch_failure_notification("attempt_ff_0001_r_000000_0", r0)]
    t = job.obtain_new_map_task("h", run_on_tpu=False)
    out.append(job.fetch_failure_notification(str(t.attempt_id), r0))
    finish_map(pkg, job, t)
    aid = job.maps[0].successful_attempt
    out += [job.fetch_failure_notification(aid, "attempt_ff_0001_r_000001_7"),
            job.fetch_failure_notification(aid,
                                           "attempt_other_0002_r_000000_0")]
    job.update_task_status(pkg.TaskStatus(
        attempt_id=pkg.TaskAttemptID.parse(r0), is_map=False,
        state=pkg.TaskState.SUCCEEDED, start_time=T0,
        finish_time=T0 + 1), "t:0")
    out.append(job.fetch_failure_notification(aid, r0))
    out.append(books(job))
    assert out[:-1] == [None] * 6
    assert out[-1]["ff_pending"] == 0
    return out


def case_replayed_success_cannot_bring_back_a_withdrawn_attempt(pkg):
    job = make_job(pkg, n_maps=1, n_reduces=1)
    finish_map(pkg, job, job.obtain_new_map_task("h", run_on_tpu=False),
               addr="t0:9")
    r0 = running_reduce(pkg, job)
    aid = job.maps[0].successful_attempt
    res = job.fetch_failure_notification(aid, r0)
    job.update_task_status(pkg.TaskStatus(
        attempt_id=pkg.TaskAttemptID.parse(aid), is_map=True,
        state=pkg.TaskState.SUCCEEDED, start_time=T0,
        finish_time=T0 + 1), "t0:9")
    b = books(job)
    assert res["withdrawn"]
    assert b["finished_maps"] == 0 and b["pending_maps"] == 1
    assert b["successful"] == [""]
    assert all(e["status"] == "OBSOLETE" for e in b["events"])
    return [res, b]


CASES = [case_distinct_reducers_until_threshold, case_single_reduce_job,
         case_profile_sums_unwound, case_repeated_loss_fails_the_job,
         case_unknown_forged_and_finished_reporters_ignored,
         case_replayed_success_cannot_bring_back_a_withdrawn_attempt]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_fetch_failure_notification_matches_jax(case):
    """TestFetchFailureNotification, each case on both packages."""
    assert case(PORT) == case(JAX)


def test_lost_runner_unwinds_and_drops_pending_reports_as_jax():
    """TestRequeueLostAttemptsUnwind::test_hybrid_profile_unwound_exactly_
    on_lost_tracker, on both packages, with a report pending for one of
    the lost outputs."""

    def run(pkg):
        job = make_job(pkg, n_maps=3, n_reduces=2)
        t0 = job.obtain_new_map_task("h", run_on_tpu=True, tpu_device_id=0)
        t1 = job.obtain_new_map_task("h", run_on_tpu=False)
        t2 = job.obtain_new_map_task("h", run_on_tpu=False)
        finish_map(pkg, job, t0, runtime=2.0, on_tpu=True, addr="lost:1")
        finish_map(pkg, job, t1, runtime=6.0, addr="lost:1")
        finish_map(pkg, job, t2, runtime=10.0, addr="ok:2")
        r0 = running_reduce(pkg, job)
        lost = [job.maps[t0.partition].successful_attempt,
                job.maps[t1.partition].successful_attempt]
        first = job.fetch_failure_notification(lost[0], r0)
        withdrawn = job.requeue_lost_attempts(lost)
        return [first, withdrawn, books(job)]

    got = run(PORT)
    assert got == run(JAX)
    b = got[2]
    assert (b["finished_maps"], b["finished_tpu_maps"]) == (1, 0)
    assert b["cpu_sum"] == 10.0 and b["ff_pending"] == 0
    assert [e["map_index"] for e in b["events"]
            if e["status"] != "OBSOLETE"] == [2]


def test_rerun_for_lost_output_may_take_a_cpu_slot_as_jax():
    """A GPU-slot map whose output was lost did not fail on the device,
    so the scheduler may place its re-run on a CPU slot, as the JAX
    package's does; and a map whose GPU-slot attempt FAILED with no
    failure class goes back for any slot, placed as the JAX package
    places it."""

    def run(pkgs, lost_output):
        pkg = pkgs
        jip = JAX if pkg is JAX_SCHED else PORT
        job = make_job(jip, n_maps=2, n_reduces=1,
                       **{"tpumr.map.kernel": "kmeans-assign"})
        t0 = job.obtain_new_map_task("host0", run_on_tpu=True,
                                     tpu_device_id=0)
        t1 = job.obtain_new_map_task("host0", run_on_tpu=False)
        finish_map(jip, job, t1, runtime=10.0)
        if lost_output:
            finish_map(jip, job, t0, runtime=1.0, on_tpu=True)
            r0 = running_reduce(jip, job)
            job.fetch_failure_notification(
                job.maps[t0.partition].successful_attempt, r0)
        else:
            job.update_task_status(jip.TaskStatus(
                attempt_id=t0.attempt_id, is_map=True, run_on_tpu=True,
                tpu_device_id=0, state=jip.TaskState.FAILED,
                start_time=T0, finish_time=T0 + 1), "t0:1")
        sched = make_scheduler(pkg, [job])
        # the GPU slot busy, one CPU slot free
        return placed(sched.assign_tasks(tracker_status(
            cpu=1, tpu=1, run_tpu=1, devices=[False])))

    lost = run(PORT_SCHED, lost_output=True)
    assert lost == run(JAX_SCHED, lost_output=True)
    assert [(p[2], p[3]) for p in lost if p[1]] == [(0, False)]
    failed = run(PORT_SCHED, lost_output=False)
    assert failed == run(JAX_SCHED, lost_output=False)
    assert [(p[2], p[3]) for p in failed if p[1]] == [(0, False)]


# --------------------------------------------------------------- locator


def _feed(events):
    return lambda cursor: events[cursor:]


def _ev(attempt, port, status="SUCCEEDED"):
    return {"map_index": 0, "attempt_id": attempt,
            "shuffle_addr": f"127.0.0.1:{port}", "status": status}


def _both(events, **kw):
    """The port's locator and the JAX package's, each over the same feed
    with a cursor of its own."""
    return (make_map_locator(_feed(events), **kw),
            jax_tt.make_map_locator(_feed(events), None, **kw))


def _state(loc, m=0):
    """What a fetcher sees: the resolved address, then the attempt and
    address a report would name."""
    return loc.resolve(m), loc.attempt_of(m), loc.addr_of(m)


A1, A2 = "127.0.0.1:7001", "127.0.0.1:7002"


def test_locator_obsolete_evicts_and_the_rerun_replaces():
    """TestMapLocatorReresolution::test_obsolete_evicts_and_rerun_replaces,
    on both packages' locators step for step."""
    events = [_ev("a0", 7001)]
    port, jax = _both(events, poll_s=0.01, timeout_s=2.0)
    try:
        assert _state(port) == _state(jax) == (A1, "a0", A1)
        cli, target = port(0), jax(0)
        assert (cli.host, cli.port) == (target.host, target.port) \
            == ("127.0.0.1", 7001)
        assert port(0) is cli   # one client per thread and address
        events += [_ev("a0", 7001, "OBSOLETE"), _ev("a1", 7002)]
        port.invalidate(0)
        jax.invalidate(0)
        assert _state(port) == _state(jax) == (A2, "a1", A2)
        assert port(0).port == jax(0).port == 7002
    finally:
        port.close()
        jax.close()
    with pytest.raises(RuntimeError, match="closed"):
        port.client(A2)


def test_locator_invalidate_falls_back_to_the_stale_address():
    """TestMapLocatorReresolution::test_invalidate_falls_back_to_stale_
    until_replaced, on both packages' locators step for step."""
    events = [_ev("a0", 7001)]
    port, jax = _both(events, poll_s=0.01, timeout_s=5.0)
    try:
        assert _state(port) == _state(jax) == (A1, "a0", A1)
        port.invalidate(0)
        jax.invalidate(0)
        # reports go on naming the demoted attempt
        assert port.attempt_of(0) == jax.attempt_of(0) == "a0"
        assert port.addr_of(0) == jax.addr_of(0) == A1
        t = time.monotonic()
        assert port.resolve(0) == jax.resolve(0) == A1   # no block
        assert time.monotonic() - t < 2.0
        port.invalidate(0)
        jax.invalidate(0)
        events += [_ev("a0", 7001, "OBSOLETE"), _ev("a1", 7002)]
        assert _state(port) == _state(jax) == (A2, "a1", A2)
    finally:
        port.close()
        jax.close()


def test_locator_ignores_a_tombstone_for_an_attempt_never_cached():
    """TestMapLocatorReresolution::test_tombstone_for_uncached_attempt_
    is_inert (a late joiner replaying the feed from 0), and a tombstone
    for another attempt than the cached one, on both packages' locators;
    then the port's handoff-only final withdrawal."""
    events = [_ev("a0", 7001), _ev("a0", 7001, "OBSOLETE"), _ev("a1", 7002)]
    port, jax = _both(events, poll_s=0.01, timeout_s=2.0)
    try:
        assert _state(port) == _state(jax) == (A2, "a1", A2)
        events.append(_ev("a0", 7001, "OBSOLETE"))   # a0 is not cached
        port.invalidate(0)
        jax.invalidate(0)
        assert _state(port) == _state(jax) == (A2, "a1", A2)
    finally:
        port.close()
        jax.close()
    withdrawn = events[:2]
    gone = make_map_locator(_feed(withdrawn), poll_s=0.01, timeout_s=2.0,
                            withdrawn_is_final=True)
    t = time.monotonic()
    with pytest.raises(OutputWithdrawn):
        gone.resolve(0)
    assert time.monotonic() - t < 1.0
    # a map output: both packages wait for the re-run, to the timeout
    port, jax = _both(withdrawn, poll_s=0.01, timeout_s=0.2)
    for loc in (port, jax):
        with pytest.raises(TimeoutError):
            loc.resolve(0)
        loc.close()


# ------------------------------------------------------- fi determinism


def _sequence(mod, conf, n=64, point="seeded.point"):
    out = []
    for _ in range(n):
        try:
            mod.maybe_fail(point, conf)
            out.append(0)
        except mod.InjectedFault:
            out.append(1)
    return out


@pytest.mark.parametrize("seed", [1234, 1, 2])
def test_seeded_faults_replay_bit_for_bit_as_jax(seed):
    """TestSeededFaultInjection::test_same_seed_replays_bit_identically
    and ::test_different_seeds_diverge: one seed gives the same sequence
    twice, the JAX package's sequence, and another seed's differs."""
    conf = conf_with(**{"tpumr.fi.seeded.point.probability": 0.5,
                        "tpumr.fi.seed": seed})
    other = conf_with(**{"tpumr.fi.seeded.point.probability": 0.5,
                         "tpumr.fi.seed": seed + 7})
    try:
        fi.reset()
        first = _sequence(fi, conf)
        fi.reset()
        assert _sequence(fi, conf) == first
        assert 0 < sum(first) < 64
        assert fi.fired("seeded.point") == sum(first)
        jax_fi.reset()
        assert _sequence(jax_fi, conf) == first
        fi.reset()
        assert _sequence(fi, other) != first
    finally:
        fi.reset()
        jax_fi.reset()


def test_fault_points_honour_max_failures():
    conf = conf_with(**{"tpumr.fi.p.probability": 1.0,
                        "tpumr.fi.p.max.failures": 2})
    try:
        fi.reset()
        assert _sequence(fi, conf, n=5, point="p") == [1, 1, 0, 0, 0]
        assert not fi.fires("q", conf) and not fi.fires("p", None)
    finally:
        fi.reset()


# --------------------------------------------------------- end to end


TEXT = b"".join(b"w%02d x\n" % (i % 31) for i in range(3000))


def _wordcount(conf, pkg, inp, out):
    conf.set_input_paths(inp)
    conf.set_output_path(out)
    conf.set("mapred.mapper.class", f"{pkg}.ops.wordcount.WordCountCpuMapper")
    conf.set("mapred.reducer.class", f"{pkg}.examples.basic.LongSumReducer")
    conf.set("mapred.max.split.size", len(TEXT) // 2 + 1)   # 2 maps
    conf.set("mapred.map.tasks", 2)
    conf.set_num_reduce_tasks(2)
    return conf


def _counts(fs, out):
    counts = {}
    for st in fs.list_files(out):
        if st.path.name.startswith("part-"):
            for line in fs.read_bytes(st.path).decode().splitlines():
                k, v = line.split("\t")
                counts[k] = v
    return counts


def test_lost_map_outputs_recover_without_failing_a_reduce():
    """TestEndToEndChaos::test_lost_map_output_recovers_without_failing_
    reduces: every map's first output cannot be served
    (tpumr.fi.shuffle.serve.a0.probability=1); each map is re-executed
    once, no reduce attempt fails, and the counts are the JAX package's
    LocalJobRunner's for the same job."""
    from tpumr.fs import get_filesystem as jax_get_filesystem
    from tpumr.mapred.jobconf import JobConf as JaxJobConf
    from tpumr.mapred.local_runner import LocalJobRunner as JaxLocal
    from tpumr_torch.fs.filesystem import FileSystem
    from tpumr_torch.mapred.job_client import JobClient
    from tpumr_torch.mapred.mini_cluster import MiniMRCluster

    jfs = jax_get_filesystem("mem:///")
    jfs.write_bytes("/ffj/in.txt", TEXT)
    jconf = _wordcount(JaxJobConf(), "tpumr", "mem:///ffj/in.txt",
                       "mem:///ffj/out")
    assert JaxLocal(jconf).submit_job(jconf).successful
    want = _counts(jfs, "/ffj/out")
    assert want["x"] == "3000" and want["w00"] == "97"

    FileSystem.clear_cache()
    fi.reset()
    base = JobConf()
    base.set(DEVICE_KEY, "cpu")
    base.set("tpumr.fi.shuffle.serve.a0.probability", 1.0)
    base.set("tpumr.shuffle.fetch.retries.per.source", 1)
    base.set("tpumr.shuffle.copy.backoff.ms", 10)
    base.set("tpumr.shuffle.copy.backoff.max.ms", 100)
    base.set("mapred.max.fetch.failures.per.map", 2)
    try:
        with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0,
                           conf=base) as c:
            fs = FileSystem.get("mem:///", base)
            fs.write_bytes("mem:///ff/in.txt", TEXT)
            conf = _wordcount(c.create_job_conf(), "tpumr_torch",
                              "mem:///ff/in.txt", "mem:///ff/out")
            client = JobClient(conf)
            try:
                running = client.submit_job(conf)
                st = running.wait_for_completion(timeout=60)
                maps = running.task_reports("map")
                reduces = running.task_reports("reduce")
            finally:
                client.close()
            assert st["state"] == "SUCCEEDED", st
            assert _counts(fs, "mem:///ff/out") == want
            assert len(maps) == 2
            assert all(r["successful_attempt"].endswith("_1") for r in maps)
            assert all(r["successful_attempt"].endswith("_0")
                       for r in reduces)
            jip = c.master.jobs[running.job_id]
            assert [t.failures for t in jip.maps] == [1, 1]
            assert [t.failures for t in jip.reduces] == [0, 0]
            assert not [s for t in jip.reduces for s in t.attempts.values()
                        if s.state == "FAILED"]
            assert fi.fired("shuffle.serve.a0") >= 2
    finally:
        fi.reset()
        FileSystem.clear_cache()
