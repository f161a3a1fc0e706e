"""The port's hybrid scheduler and job bookkeeping
(tpumr_torch.mapred.scheduler.HybridQueueScheduler,
tpumr_torch.mapred.job_in_progress.JobInProgress) against the JAX
package's (tpumr.mapred.scheduler, tpumr.mapred.job_in_progress), driven
the same way.

Each case is one of tests/test_scheduler.py's, run twice: once on the JAX
package's classes and once on the port's, from the same conf dict and
split dicts, against the same fake manager (in the manner of
tests/test_scheduler.py::FakeManager) and the same runner statuses, with
the same completed task statuses at fixed start and finish times. Both
runs must give the same assignment sequence (job, kind, partition,
run_on_tpu, device id), the same per-backend means and acceleration
factor, and the same placement counts in ``status_dict``; each case also
checks the property its oracle test asserts. Deterministic: no daemons,
no clocks in the compared numbers.
"""

from types import SimpleNamespace

import pytest

import tpumr.mapred.ids as jax_ids
import tpumr.mapred.job_in_progress as jax_jip
import tpumr.mapred.jobconf as jax_jobconf
import tpumr.mapred.scheduler as jax_sched
import tpumr.mapred.task as jax_task
import tpumr_torch.mapred.ids as port_ids
import tpumr_torch.mapred.job_in_progress as port_jip
import tpumr_torch.mapred.jobconf as port_jobconf
import tpumr_torch.mapred.scheduler as port_sched
import tpumr_torch.mapred.task as port_task

JAX = SimpleNamespace(name="jax", JobID=jax_ids.JobID,
                      JobInProgress=jax_jip.JobInProgress,
                      JobConf=jax_jobconf.JobConf,
                      Hybrid=jax_sched.HybridQueueScheduler,
                      Fifo=jax_sched.FifoScheduler,
                      TaskState=jax_task.TaskState,
                      TaskStatus=jax_task.TaskStatus)
PORT = SimpleNamespace(name="port", JobID=port_ids.JobID,
                       JobInProgress=port_jip.JobInProgress,
                       JobConf=port_jobconf.JobConf,
                       Hybrid=port_sched.HybridQueueScheduler,
                       Fifo=port_sched.FifoScheduler,
                       TaskState=port_task.TaskState,
                       TaskStatus=port_task.TaskStatus)

#: the fixed clock of every completed status
T0 = 1_000_000.0


class FakeManager:
    """tests/test_scheduler.py::FakeManager."""

    def __init__(self, jobs, n_trackers=1):
        self._jobs = jobs
        self._n = n_trackers

    def running_jobs(self):
        return self._jobs

    def num_trackers(self):
        return self._n

    def total_slots(self):
        return {"cpu": 3 * self._n, "tpu": 1 * self._n,
                "reduce": 2 * self._n}


def make_job(pkg, n_maps=8, n_reduces=1, kernel=True, optional=False,
             job_num=1, hosts=None, slowstart=0.0, extra=None):
    conf = {"mapred.reduce.tasks": n_reduces,
            "mapred.reduce.slowstart.completed.maps": slowstart}
    if kernel:
        conf["tpumr.map.kernel"] = "kmeans-assign"
    if optional:
        conf["mapred.jobtracker.map.optionalscheduling"] = True
    conf.update(extra or {})
    splits = [{"locations": list(hosts or [])} for _ in range(n_maps)]
    return pkg.JobInProgress(pkg.JobID("test", job_num), conf, splits)


def tracker_status(cpu=3, tpu=1, reduce=2, run_cpu=0, run_tpu=0, run_red=0,
                   devices=None, host="host0"):
    return {"tracker_name": "tracker_0", "host": host, "shuffle_port": 0,
            "max_cpu_map_slots": cpu, "max_tpu_map_slots": tpu,
            "max_reduce_slots": reduce, "count_cpu_map_tasks": run_cpu,
            "count_tpu_map_tasks": run_tpu, "count_reduce_tasks": run_red,
            "available_tpu_devices": (devices if devices is not None
                                      else [True] * tpu)}


def make_scheduler(pkg, jobs, n_trackers=1, fifo=False, **conf_kv):
    sched = (pkg.Fifo if fifo else pkg.Hybrid)()
    conf = pkg.JobConf()
    for k, v in conf_kv.items():
        conf.set(k, v)
    sched.configure(conf)
    sched.set_manager(FakeManager(jobs, n_trackers))
    return sched


def finish(pkg, job, task, runtime, state="SUCCEEDED", diagnostics=""):
    st = pkg.TaskStatus(attempt_id=task.attempt_id, is_map=task.is_map,
                        state=getattr(pkg.TaskState, state),
                        start_time=T0, finish_time=T0 + runtime,
                        run_on_tpu=task.run_on_tpu,
                        tpu_device_id=task.tpu_device_id,
                        diagnostics=diagnostics)
    job.update_task_status(st, "h:0")


def profile(pkg, job, cpu_s=10.0, tpu_s=1.0):
    """One finished map on each backend (the cases' profile)."""
    for on_tpu, runtime in [(False, cpu_s), (True, tpu_s)]:
        t = job.obtain_new_map_task("host0", run_on_tpu=on_tpu,
                                    tpu_device_id=0 if on_tpu else -1)
        finish(pkg, job, t, runtime)


def placed(tasks):
    """The compared form of one heartbeat's assignment."""
    return [(str(t.attempt_id.task.job), t.is_map, t.partition,
             bool(t.run_on_tpu), int(t.tpu_device_id)) for t in tasks]


def summary(job):
    st = job.status_dict()
    return {k: st[k] for k in (
        "state", "finished_maps", "finished_tpu_maps", "finished_cpu_maps",
        "num_maps", "cpu_map_mean_time", "tpu_map_mean_time",
        "acceleration_factor", "placement_seq")} | {
        "pending_maps": job.pending_map_count(),
        "pending_reduces": job.pending_reduce_count()}


# ------------------------------------------------------------------ cases
# Each takes a package namespace and returns what is compared; the
# oracle's own assertion follows in the same function.


def case_fills_both_pools(pkg):
    """test_fills_both_pools_with_device_ids."""
    job = make_job(pkg, n_maps=8)
    sched = make_scheduler(pkg, [job])
    tasks = sched.assign_tasks(tracker_status(cpu=3, tpu=2,
                                              devices=[True, True]))
    got = placed(tasks)
    assert sorted(p[4] for p in got if p[3]) == [0, 1]
    assert len([p for p in got if p[1] and not p[3]]) == 3
    assert len([p for p in got if not p[1]]) == 1
    return {"assigned": got, "job": summary(job)}


def case_kernel_gate(pkg):
    """test_kernel_gate_blocks_tpu_assignment."""
    job = make_job(pkg, kernel=False)
    got = placed(make_scheduler(pkg, [job]).assign_tasks(tracker_status()))
    assert not any(p[3] for p in got)
    assert len([p for p in got if p[1]]) == 3
    return {"assigned": got}


def case_no_free_device(pkg):
    """test_no_free_device_no_tpu_task."""
    job = make_job(pkg)
    got = placed(make_scheduler(pkg, [job]).assign_tasks(
        tracker_status(tpu=1, devices=[False])))
    assert not any(p[3] for p in got)
    return {"assigned": got}


def case_optional_starves_cpu(pkg):
    """test_optional_scheduling_starves_cpu_when_load_fits_tpu."""
    job = make_job(pkg, n_maps=20, optional=True)
    profile(pkg, job)
    assert job.acceleration_factor() == 10.0
    got = placed(make_scheduler(pkg, [job], n_trackers=2)
                 .assign_tasks(tracker_status()))
    assert [p[3] for p in got if p[1]] == [True]
    fresh = make_job(pkg, n_maps=20, optional=True, job_num=2)
    got2 = placed(make_scheduler(pkg, [fresh], n_trackers=2)
                  .assign_tasks(tracker_status()))
    assert len([p for p in got2 if p[1] and not p[3]]) == 3
    return {"assigned": [got, got2], "job": summary(job),
            "fresh": summary(fresh)}


def case_optional_keeps_cpu_under_load(pkg):
    """test_optional_scheduling_keeps_cpu_under_heavy_load."""
    job = make_job(pkg, n_maps=500, optional=True)
    profile(pkg, job)
    got = placed(make_scheduler(pkg, [job], n_trackers=2)
                 .assign_tasks(tracker_status()))
    assert len([p for p in got if p[1] and not p[3]]) == 3
    return {"assigned": got, "job": summary(job)}


def case_optional_at_the_boundary(pkg):
    """The starvation rule is strict: pending 20 == 10 x 1 x 2 keeps the
    CPU pass, pending 19 starves it."""
    job = make_job(pkg, n_maps=22, optional=True)
    profile(pkg, job)
    sched = make_scheduler(pkg, [job], n_trackers=2)
    got = placed(sched.assign_tasks(tracker_status(devices=[False])))
    assert len(got) == 4 and not any(p[3] for p in got if p[1])
    job2 = make_job(pkg, n_maps=21, optional=True, job_num=2)
    profile(pkg, job2)
    got2 = placed(make_scheduler(pkg, [job2], n_trackers=2)
                  .assign_tasks(tracker_status(devices=[False])))
    assert [p for p in got2 if p[1]] == []
    return {"assigned": [got, got2], "job": summary(job)}


def case_minimize(pkg):
    """test_minimize_mode_puts_everything_on_tpu_when_faster."""
    job = make_job(pkg, n_maps=10)
    profile(pkg, job)
    got = placed(make_scheduler(pkg, [job],
                                **{"tpumr.scheduler.mode": "minimize"})
                 .assign_tasks(tracker_status()))
    assert [p[3] for p in got if p[1]] == [True]
    job2 = make_job(pkg, n_maps=10, job_num=2)
    profile(pkg, job2, cpu_s=1.0, tpu_s=10.0)
    got2 = placed(make_scheduler(pkg, [job2],
                                 **{"tpumr.scheduler.mode": "minimize"})
                  .assign_tasks(tracker_status()))
    assert len([p for p in got2 if p[1] and not p[3]]) == 3
    return {"assigned": [got, got2], "job": summary(job),
            "job2": summary(job2)}


def case_per_job_minimize(pkg):
    """test_per_job_minimize_mode_override."""
    job = make_job(pkg, n_maps=10,
                   extra={"tpumr.scheduler.mode": "minimize"})
    profile(pkg, job)
    got = placed(make_scheduler(pkg, [job]).assign_tasks(tracker_status()))
    assert [p[3] for p in got if p[1]] == [True]
    plain = make_job(pkg, n_maps=10, job_num=2)
    profile(pkg, plain)
    got2 = placed(make_scheduler(pkg, [plain])
                  .assign_tasks(tracker_status()))
    assert len([p for p in got2 if p[1] and not p[3]]) == 3
    return {"assigned": [got, got2], "job": summary(job)}


def case_locality(pkg):
    """test_locality_preference."""
    job = make_job(pkg, n_maps=4, hosts=["far"])
    job.host_cache = {"host0": {2}, "far": {0, 1, 3}}
    got = placed(make_scheduler(pkg, [job]).assign_tasks(
        tracker_status(cpu=1, tpu=0, host="host0")))
    assert got[0][2] == 2
    return {"assigned": got}


def case_fifo_across_jobs(pkg):
    """test_fifo_across_jobs."""
    j1 = make_job(pkg, n_maps=2, job_num=1, kernel=False)
    j2 = make_job(pkg, n_maps=8, job_num=2, kernel=False)
    got = placed(make_scheduler(pkg, [j1, j2]).assign_tasks(
        tracker_status(cpu=4, tpu=0)))
    order = [p[0] for p in got if p[1]]
    assert order[:2] == ["job_test_0001"] * 2
    assert all(j == "job_test_0002" for j in order[2:])
    return {"assigned": got}


def case_priority(pkg):
    """test_priority_reorders_fifo_queue."""
    j1 = make_job(pkg, n_maps=2, job_num=1, kernel=False)
    j2 = make_job(pkg, n_maps=2, job_num=2, kernel=False)
    j2.priority = "HIGH"
    got = placed(make_scheduler(pkg, [j1, j2]).assign_tasks(
        tracker_status(cpu=4, tpu=0)))
    order = [p[0] for p in got if p[1]]
    assert order[:2] == ["job_test_0002"] * 2
    return {"assigned": got}


def case_one_reduce_per_heartbeat(pkg):
    """test_fills_both_pools_with_device_ids' reduce clause, over several
    heartbeats, and the slow-start gate: a job with the default 5%
    slow-start gets no reduce before a map finished."""
    job = make_job(pkg, n_maps=2, n_reduces=3)
    sched = make_scheduler(pkg, [job])
    beats = [placed(sched.assign_tasks(tracker_status(reduce=3)))
             for _ in range(3)]
    assert [len([p for p in b if not p[1]]) for b in beats] == [1, 1, 1]
    gated = make_job(pkg, n_maps=4, n_reduces=1, job_num=2,
                     slowstart=0.05)
    gsched = make_scheduler(pkg, [gated])
    first = placed(gsched.assign_tasks(tracker_status(cpu=1, tpu=0)))
    assert not [p for p in first if not p[1]]
    t = gated.obtain_new_map_task("host0", run_on_tpu=False)
    finish(pkg, gated, t, 2.0)
    second = placed(gsched.assign_tasks(tracker_status(cpu=0, tpu=0)))
    assert [p for p in second if not p[1]]
    return {"assigned": beats + [first, second], "job": summary(job),
            "gated": summary(gated)}


def case_failure_requeues_then_fails(pkg):
    """test_failure_requeues_and_eventually_fails_job, on both pools: a
    failed CPU attempt is requeued to either pool, a failed accelerator
    attempt to the accelerator pool (a CPU slot may not take it in the
    port: test_failed_gpu_attempt_waits_for_a_gpu_slot)."""
    job = make_job(pkg, n_maps=1)
    attempts = []
    for attempt in range(4):
        on_tpu = attempt > 0
        t = job.obtain_new_map_task("h", run_on_tpu=on_tpu,
                                    tpu_device_id=0 if on_tpu else -1)
        assert t is not None and t.attempt_id.attempt == attempt
        attempts.append(placed([t]))
        finish(pkg, job, t, 1.0, state="FAILED", diagnostics="boom")
    assert job.state == "FAILED" and "4 times" in job.error
    return {"assigned": attempts, "job": summary(job),
            "error": job.error}


def case_convergence_timeline(pkg):
    """test_within_job_convergence_timeline."""
    job = make_job(pkg, n_maps=24, optional=True)
    sched = make_scheduler(pkg, [job], n_trackers=2)
    beats = []
    for _hb in range(100):
        if job.pending_map_count() == 0:
            break
        tasks = [t for t in sched.assign_tasks(tracker_status()) if t.is_map]
        beats.append(placed(tasks))
        for t in tasks:
            finish(pkg, job, t, 1.0 if t.run_on_tpu else 10.0)
    seq = [p[3] for b in beats for p in b]
    assert job.pending_map_count() == 0
    assert not all(seq[:4]) and seq[-1] and seq[-2]
    tail = len(seq) - max((i + 1 for i, b in enumerate(seq) if not b),
                          default=0)
    assert tail >= 10, (seq, tail)
    return {"assigned": beats, "job": summary(job)}


def case_fifo_scheduler_never_starves(pkg):
    """FifoScheduler: optional scheduling off, so a profiled job whose
    pending maps fit the accelerator still fills the CPU slots."""
    job = make_job(pkg, n_maps=20, optional=True)
    profile(pkg, job)
    got = placed(make_scheduler(pkg, [job], n_trackers=2, fifo=True)
                 .assign_tasks(tracker_status()))
    assert len([p for p in got if p[1] and not p[3]]) == 3
    return {"assigned": got}


def case_ewma_profile(pkg):
    """tpumr.profile.ewma: the means follow the EWMA of the runtimes."""
    job = make_job(pkg, n_maps=6, extra={"tpumr.profile.ewma": 0.5})
    for on_tpu, runtime in [(False, 8.0), (False, 4.0), (True, 2.0),
                            (True, 1.0)]:
        t = job.obtain_new_map_task("host0", run_on_tpu=on_tpu,
                                    tpu_device_id=0 if on_tpu else -1)
        finish(pkg, job, t, runtime)
    assert job.cpu_map_mean_time() == 6.0
    assert job.tpu_map_mean_time() == 1.5
    return {"job": summary(job)}


CASES = [case_fills_both_pools, case_kernel_gate, case_no_free_device,
         case_optional_starves_cpu, case_optional_keeps_cpu_under_load,
         case_optional_at_the_boundary,
         case_minimize, case_per_job_minimize, case_locality,
         case_fifo_across_jobs, case_priority, case_one_reduce_per_heartbeat,
         case_failure_requeues_then_fails, case_convergence_timeline,
         case_fifo_scheduler_never_starves, case_ewma_profile]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_scheduler_matches_jax(case):
    assert case(PORT) == case(JAX)


def test_status_dict_placement_and_reports_match_jax():
    """The placement stamps on the task reports and the timeline's
    sequence, after the convergence run, are the JAX package's."""
    def run(pkg):
        job = make_job(pkg, n_maps=12, optional=True)
        sched = make_scheduler(pkg, [job], n_trackers=1)
        while job.pending_map_count():
            for t in sched.assign_tasks(tracker_status()):
                if t.is_map:
                    finish(pkg, job, t, 0.5 if t.run_on_tpu else 4.0)
        reports = [(m.report.run_on_tpu, m.report.tpu_device_id,
                    m.report.state) for m in job.maps]
        return reports, job.placement_timeline()["seq"], summary(job)

    assert run(PORT) == run(JAX)


@pytest.mark.parametrize("failure_class",
                         ["device", "compile", "user", "oom", "timeout", ""])
def test_failed_gpu_attempt_is_placed_as_jax(failure_class):
    """A map whose accelerator attempt FAILED is placed as the JAX package
    places it (tests/test_accel_fault.py::TestTipDemotion): a device or
    compile failure demotes it to the CPU slots (TPU_DEMOTIONS, the next
    accelerator slot takes the other map, the CPU slot takes it); any
    other class sends it back for any slot, the accelerator first."""
    def run(pkg):
        job = make_job(pkg, n_maps=2, n_reduces=0)
        sched = make_scheduler(pkg, [job])
        seq = []
        first = sched.assign_tasks(tracker_status(cpu=0))
        seq.append(placed(first))
        st = pkg.TaskStatus(attempt_id=first[0].attempt_id, is_map=True,
                            state=pkg.TaskState.FAILED, start_time=T0,
                            finish_time=T0 + 1.0, run_on_tpu=True,
                            tpu_device_id=0, diagnostics="boom",
                            failure_class=failure_class)
        job.update_task_status(st, "h:0")
        # the accelerator slot alone, then the CPU slot alone
        for status in (tracker_status(cpu=0), tracker_status(tpu=0)):
            got = sched.assign_tasks(status)
            seq.append(placed(got) + [t.attempt_id.attempt for t in got])
            for t in got:
                finish(pkg, job, t, 0.5 if t.run_on_tpu else 4.0)
        seq.append(placed(sched.assign_tasks(tracker_status())))
        d = job.status_dict()
        return (seq, summary(job), d["tpu_demoted_tips"], d["tpu_disabled"],
                job.counters.to_dict(), job.maps[0].tpu_failures)

    port, jax = run(PORT), run(JAX)
    assert port == jax
    demoted = failure_class in ("device", "compile")
    seq = port[0]
    # map 0 on the accelerator again unless demoted; then on the CPU
    assert seq[1][0][2:4] == ((1, True) if demoted else (0, True))
    assert seq[2][0][2:4] == ((0, False) if demoted else (1, False))
    assert port[2] == int(demoted) and port[5] == int(demoted)
    assert port[1]["state"] == "SUCCEEDED"


def test_cpu_starved_heartbeats_are_counted():
    """status_dict's cpu_starved_heartbeats: one per heartbeat in which
    the factor took a job's CPU budget to 0 while a CPU slot was free and
    a map pending; none where the CPU pass ran or had no free slot."""
    job = make_job(PORT, n_maps=20, optional=True)
    profile(PORT, job)
    sched = make_scheduler(PORT, [job], n_trackers=2)
    for _ in range(3):
        sched.assign_tasks(tracker_status(devices=[False]))
    sched.assign_tasks(tracker_status(run_cpu=3, devices=[False]))
    assert job.status_dict()["cpu_starved_heartbeats"] == 3
    loaded = make_job(PORT, n_maps=500, optional=True, job_num=2)
    profile(PORT, loaded)
    make_scheduler(PORT, [loaded], n_trackers=2).assign_tasks(
        tracker_status())
    assert loaded.status_dict()["cpu_starved_heartbeats"] == 0


def test_priority_validation_matches_jax():
    """test_priority_from_conf_and_validation."""
    for pkg, mod in ((JAX, jax_jip), (PORT, port_jip)):
        conf = {"mapred.reduce.tasks": 0, "mapred.job.priority": "very_low"}
        assert pkg.JobInProgress(pkg.JobID("test", 4), conf,
                                 [{"locations": []}]).priority == "VERY_LOW"
        with pytest.raises(ValueError, match="unknown job priority"):
            mod.normalize_priority("URGENT")
