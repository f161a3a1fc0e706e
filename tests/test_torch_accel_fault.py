"""The port's accelerator fault-tolerance decisions against the JAX
package's, on the CPU: the failure classes (tpumr_torch.mapred.task), the
classed fault seams (tpumr_torch.utils.fi), the demotion and job
quarantine (tpumr_torch.mapred.job_in_progress, .scheduler) and the
per-device quarantine (tpumr_torch.mapred.node_health.TpuDeviceHealth).

Oracle: tests/test_accel_fault.py, whose cases run here through both
packages' classes from the same conf dicts, split dicts and task statuses
(fixed start and finish times), in the manner of
tests/test_torch_scheduler.py. Each comparison takes the placement
sequence, the ``status_dict`` fields, the counters and the drained
decisions, which must be equal; each case also checks what its oracle
asserts. The classification cases state each package's class: where the
JAX package reads XLA wording and a cold compile, the port reads the CUDA
runtime's wording and the kernel build's own error for a compile.
"""

import os
from types import SimpleNamespace

import pytest
import torch

import tpumr.mapred.ids as jax_ids
import tpumr.mapred.job_in_progress as jax_jip
import tpumr.mapred.jobconf as jax_jobconf
import tpumr.mapred.node_health as jax_health
import tpumr.mapred.scheduler as jax_sched
import tpumr.mapred.task as jax_task
import tpumr.utils.fi as jax_fi
import tpumr_torch.mapred.ids as port_ids
import tpumr_torch.mapred.job_in_progress as port_jip
import tpumr_torch.mapred.jobconf as port_jobconf
import tpumr_torch.mapred.node_health as port_health
import tpumr_torch.mapred.scheduler as port_sched
import tpumr_torch.mapred.task as port_task
import tpumr_torch.utils.fi as port_fi
from tpumr_torch.ops import native

JAX = SimpleNamespace(name="jax", JobID=jax_ids.JobID,
                      JobInProgress=jax_jip.JobInProgress,
                      JobConf=jax_jobconf.JobConf,
                      Hybrid=jax_sched.HybridQueueScheduler,
                      TaskState=jax_task.TaskState,
                      TaskStatus=jax_task.TaskStatus,
                      TaskAttemptID=jax_ids.TaskAttemptID,
                      task=jax_task, fi=jax_fi,
                      TpuDeviceHealth=jax_health.TpuDeviceHealth)
PORT = SimpleNamespace(name="port", JobID=port_ids.JobID,
                       JobInProgress=port_jip.JobInProgress,
                       JobConf=port_jobconf.JobConf,
                       Hybrid=port_sched.HybridQueueScheduler,
                       TaskState=port_task.TaskState,
                       TaskStatus=port_task.TaskStatus,
                       TaskAttemptID=port_ids.TaskAttemptID,
                       task=port_task, fi=port_fi,
                       TpuDeviceHealth=port_health.TpuDeviceHealth)
BOTH = [JAX, PORT]

#: the fixed clock of every completed status
T0 = 1_000_000.0
FI_SEED = "20260804"
DEVICE, COMPILE, USER, OOM, TIMEOUT = ("device", "compile", "user", "oom",
                                       "timeout")


def _conf(pkg, **kv):
    conf = pkg.JobConf()
    for k, v in kv.items():
        conf.set(k, v)
    return conf


# ------------------------------------------------------- classification


def _shape_mismatch() -> RuntimeError:
    """What a mapper's torch.mm raises on mismatched shapes."""
    try:
        torch.mm(torch.ones(2, 3), torch.ones(2, 3))
    except RuntimeError as e:
        return e
    raise AssertionError("torch.mm accepted mismatched shapes")


#: (label, exception factory, JAX package's class, port's class) for the
#: accelerator runner's rule; the generic rule follows in its own test
ACCEL_CASES = [
    ("site tag", lambda: port_task.tag_failure(RuntimeError("boom"), DEVICE),
     DEVICE, DEVICE),
    ("MemoryError", MemoryError, OOM, OOM),
    ("XLA resource exhausted",
     lambda: RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying "
                          "to allocate"), OOM, OOM),
    ("plain TypeError", lambda: TypeError("unhashable"), USER, USER),
    # XLA's wording indicts the device in the JAX package only
    ("XLA stream executor",
     lambda: RuntimeError("INTERNAL: XLA stream executor failure"),
     DEVICE, USER),
    # the port's own cases
    ("torch.OutOfMemoryError",
     lambda: torch.OutOfMemoryError(
         "CUDA out of memory. Tried to allocate 2.00 GiB"), OOM, OOM),
    ("CUDA error wording",
     lambda: RuntimeError("CUDA error: an illegal memory access was "
                          "encountered"), USER, DEVICE),
    ("the port's launch failure",
     lambda: RuntimeError("kmeans_assign launch failed: cudaError 9"),
     USER, DEVICE),
    ("cuBLAS status",
     lambda: RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling "
                          "cublasSgemm"), USER, DEVICE),
    ("CUDA OOM wording is oom first",
     lambda: RuntimeError("CUDA error: out of memory"), OOM, OOM),
    ("shape mismatch in a mapper's torch.mm", _shape_mismatch, USER, USER),
    ("'torch' in a message indicts nothing",
     lambda: ValueError("torch tensor of the wrong dtype"), USER, USER),
]


@pytest.mark.parametrize("label,make,jax_class,port_class", ACCEL_CASES,
                         ids=[c[0] for c in ACCEL_CASES])
def test_accelerator_classification(label, make, jax_class, port_class):
    """TestFailureClassification (tests/test_accel_fault.py:44-100) and
    the port's CUDA cases through each package's accelerator rule."""
    assert jax_task.classify_accelerator_exception(make()) == jax_class
    assert port_task.classify_accelerator_exception(make()) == port_class


def test_accelerator_error_is_device(monkeypatch):
    """torch.AcceleratorError (where the installed torch has none, a
    stand-in under that name) is device, whatever its text says."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is None:
        accel = type("AcceleratorError", (RuntimeError,), {})
        monkeypatch.setattr(torch, "AcceleratorError", accel, raising=False)
    e = accel.__new__(accel)
    assert port_task.classify_accelerator_exception(e) == DEVICE


def test_generic_rule_matches_jax():
    """classify_exception, the settle's rule: a tag wins, the first stamp
    wins, memory is oom, the rest user; the same in both packages."""
    for pkg in BOTH:
        e = pkg.task.tag_failure(RuntimeError("boom"), DEVICE)
        pkg.task.tag_failure(e, USER)
        assert pkg.task.classify_exception(e) == DEVICE
        assert pkg.task.classify_exception(MemoryError()) == OOM
        assert pkg.task.classify_exception(TypeError("x")) == USER
        assert pkg.task.classify_exception(
            RuntimeError("CUDA error: an illegal memory access")) == USER
    assert port_task.classify_exception(
        torch.OutOfMemoryError("CUDA out of memory")) == OOM


def test_compile_is_tagged_at_its_site_not_guessed(monkeypatch, tmp_path):
    """The JAX package guesses compile from a cold dispatch's text; the
    port knows it by the error its build raises (``KernelBuildError``):
    nvcc missing, nvcc failing, the library not loading. The same text from
    elsewhere is user code's."""
    text = RuntimeError("Mosaic lowering failed: unsupported op")
    assert jax_task.classify_accelerator_exception(
        text, compile_cold=True) == COMPILE
    assert port_task.classify_accelerator_exception(text) == USER

    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "BUILD_LOG", str(tmp_path / "nvcc.log"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="CUDA kernel build failed") as ei:
        native.build()
    assert port_task.classify_accelerator_exception(ei.value) == COMPILE

    import shutil
    import torch.utils.cpp_extension as ext
    monkeypatch.undo()
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found") as ei:
        native._nvcc()
    assert port_task.classify_accelerator_exception(ei.value) == COMPILE

    monkeypatch.undo()
    junk = tmp_path / "junk.so"
    junk.write_bytes(b"not a shared library")
    monkeypatch.setattr(native, "LIBRARY", str(junk))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", lambda: 0.0)
    with pytest.raises(native.KernelBuildError, match="did not load") as ei:
        native.load()
    assert isinstance(ei.value.__cause__, OSError)
    assert port_task.classify_exception(ei.value) == COMPILE


def test_runner_finds_the_kernel_its_mapper_class_registers():
    """A node runner in a process of its own has imported no example: the
    job's mapper class, loaded by name, registers the kernel defined beside
    it (``examples/sleep``), as the JAX package's runner gets it by
    importing the job's classes. The kernel registry loads no program."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "from tpumr_torch.mapred.gpu_runner import job_kernel\n"
        "from tpumr_torch.mapred.jobconf import JobConf\n"
        "from tpumr_torch.ops import get_kernel, kernels\n"
        "assert 'sleep' not in kernels()\n"
        "try:\n"
        "    get_kernel('sleep')\n"
        "    raise SystemExit('the registry loaded a program')\n"
        "except KeyError:\n"
        "    pass\n"
        "conf = JobConf()\n"
        "conf.set('mapred.mapper.class', "
        "'tpumr_torch.examples.sleep.SleepMapper')\n"
        "conf.set_map_kernel('sleep')\n"
        "assert job_kernel(conf).name == 'sleep'\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_injected_faults_carry_their_class():
    """maybe_fail's failure_class stamp, and the accelerator seams through
    each package's runner hook, classed as the fault they stand for."""
    from tpumr.mapred.tpu_runner import _maybe_fail_accelerator as jax_seam
    from tpumr_torch.mapred.gpu_runner import \
        _maybe_fail_accelerator as port_seam
    for pkg, seam in ((JAX, jax_seam), (PORT, port_seam)):
        pkg.fi.reset()
        try:
            conf = _conf(pkg, **{"tpumr.fi.classed.point.probability": 1.0})
            with pytest.raises(pkg.fi.InjectedFault) as ei:
                pkg.fi.maybe_fail("classed.point", conf,
                                  failure_class=DEVICE)
            assert pkg.task.classify_exception(ei.value) == DEVICE
            got = []
            for point in ("tpu.compile", "tpu.execute", "tpu.execute.d1"):
                conf = _conf(pkg, **{f"tpumr.fi.{point}.probability": 1.0})
                with pytest.raises(pkg.fi.InjectedFault) as ei:
                    seam(conf, 1)
                got.append(pkg.task.classify_exception(ei.value))
            seam(_conf(pkg, **{"tpumr.fi.tpu.execute.d1.probability": 1.0}),
                 0)                       # another card: no fault
            assert got == [COMPILE, DEVICE, DEVICE]
        finally:
            pkg.fi.reset()


def test_fires_seam_matches_jax():
    """TestFiresSeam: fires honours probability and limit, and shares the
    seeded stream with maybe_fail; the same draws in both packages."""
    seqs = []
    for pkg in BOTH:
        pkg.fi.reset()
        try:
            conf = _conf(pkg, **{"tpumr.fi.behave.probability": 1.0,
                                 "tpumr.fi.behave.max.failures": 2})
            limited = [pkg.fi.fires("behave", conf) for _ in range(4)]
            assert limited == [True, True, False, False]
            assert pkg.fi.fired("behave") == 2
            a = _conf(pkg, **{"tpumr.fi.det.probability": 0.5,
                              "tpumr.fi.seed": FI_SEED})
            seq = [pkg.fi.fires("det", a) for _ in range(64)]
            pkg.fi.reset()
            seq2 = []
            for _ in range(64):
                try:
                    pkg.fi.maybe_fail("det", a)
                    seq2.append(False)
                except pkg.fi.InjectedFault:
                    seq2.append(True)
            assert seq == seq2 and 0 < sum(seq) < 64
            seqs.append(seq)
        finally:
            pkg.fi.reset()
    assert seqs[0] == seqs[1]


def test_runner_classifies_at_the_execute_site(tmp_path):
    """A CUDA error raised inside a kernel mapper on the accelerator slot
    leaves the port's runner classed device; the same raised by user
    code's shape mismatch stays user (tpu_runner.py:305-316)."""
    from tpumr_torch.fs.filesystem import FileSystem
    from tpumr_torch.mapred.map_task import run_map_task
    from tpumr_torch.mapred.input_formats import TextInputFormat
    from tpumr_torch.mapred.task import Task
    from tpumr_torch.ops.registry import KernelMapper, register_kernel

    class Raising(KernelMapper):
        name = "test-raising"

        def map_batch(self, batch, conf, task):
            raise conf.get("test.raise")()

    register_kernel(Raising())
    inp = tmp_path / "in.txt"
    inp.write_bytes(b"a b\nc\n")
    conf = port_jobconf.JobConf()
    conf.set("tpumr_torch.device", "cpu")
    conf.set_input_paths(f"file://{inp}")
    conf.set_input_format(TextInputFormat)
    conf.set_map_kernel("test-raising")
    splits = TextInputFormat().get_splits(conf, 1)
    got = []
    for make in (lambda: RuntimeError("CUDA error: unspecified launch "
                                      "failure"), _shape_mismatch):
        conf.set("test.raise", make)
        task = Task(port_ids.TaskAttemptID.parse(
            "attempt_t_0001_m_000000_0"), 0, num_reduces=1,
            split=splits[0].to_dict(), run_on_tpu=True, tpu_device_id=0)
        with pytest.raises(RuntimeError) as ei:
            run_map_task(conf, task, str(tmp_path / "map"))
        got.append(port_task.classify_exception(ei.value))
    FileSystem.clear_cache()
    assert got == [DEVICE, USER]


def test_sleep_example_matches_jax_locally(tmp_path):
    """examples sleep in both packages, locally: the same part files (the
    reduces write nothing; one part a reduce)."""
    import os
    from tpumr.examples.sleep import sleep as jax_sleep
    from tpumr_torch.examples import main as examples_main
    from tpumr_torch.fs.filesystem import FileSystem
    args = ["-m", "3", "-r", "2", "--map-ms", "20", "--reduce-ms", "10"]
    assert jax_sleep(args + ["--work", f"file://{tmp_path}/jax"]) == 0
    assert examples_main(["sleep", *args, "--work", f"file://{tmp_path}/port",
                          "-D", "tpumr_torch.device=cpu"]) == 0
    FileSystem.clear_cache()
    parts = []
    for side in ("jax", "port"):
        out = tmp_path / side / "out"
        parts.append({n: (out / n).read_bytes() for n in sorted(
            os.listdir(out)) if n.startswith("part-")})
    assert parts[0] == parts[1] and len(parts[0]) == 2


# ------------------------------------------ demotion and job quarantine


def _job(pkg, n_maps=2, n_reduces=1, **conf):
    base = {"mapred.reduce.tasks": n_reduces,
            "mapred.speculative.execution": False,
            "mapred.reduce.slowstart.completed.maps": 0.0,
            "tpumr.map.kernel": "sleep"}
    base.update(conf)
    return pkg.JobInProgress(pkg.JobID("af", 1), base,
                             [{"locations": []} for _ in range(n_maps)])


def _fail(pkg, job, task, failure_class="", on_tpu=True, runtime=1.0):
    job.update_task_status(pkg.TaskStatus(
        attempt_id=task.attempt_id, is_map=task.is_map, run_on_tpu=on_tpu,
        tpu_device_id=task.tpu_device_id, state=pkg.TaskState.FAILED,
        failure_class=failure_class, start_time=T0,
        finish_time=T0 + runtime), "t:0")


def _finish(pkg, job, task, runtime=1.0, on_tpu=False):
    job.update_task_status(pkg.TaskStatus(
        attempt_id=task.attempt_id, is_map=task.is_map, run_on_tpu=on_tpu,
        state=pkg.TaskState.SUCCEEDED, start_time=T0,
        finish_time=T0 + runtime), "t:0")


def _obtain(job, on_tpu):
    t = job.obtain_new_map_task("h", run_on_tpu=on_tpu,
                                tpu_device_id=0 if on_tpu else -1)
    return None if t is None else (t.partition, t.attempt_id.attempt,
                                   bool(t.run_on_tpu), t)


def _state(job):
    """What the two packages must agree on after a sequence."""
    st = job.status_dict()
    keys = ("state", "finished_maps", "finished_tpu_maps",
            "finished_cpu_maps", "cpu_map_mean_time", "tpu_map_mean_time",
            "acceleration_factor", "placement_seq", "tpu_disabled",
            "tpu_demoted_tips")
    return ({k: st[k] for k in keys}, job.counters.to_dict(),
            [m.tpu_failures for m in job.maps],
            [m.failures for m in job.maps], job.tpu_eligible(),
            job.cpu_pinned_pending_count())


def _strip(placement):
    return None if placement is None else placement[:3]


def _both(case):
    """Run ``case`` on each package; the results must be equal."""
    port, jax = case(PORT), case(JAX)
    assert port == jax
    return port


def test_device_failure_pins_the_map_to_the_cpu():
    """tests/test_accel_fault.py::TestTipDemotion::
    test_device_failure_pins_tip_cpu_only."""
    def case(pkg):
        job = _job(pkg, n_maps=1)
        t = _obtain(job, True)
        _fail(pkg, job, t[3], DEVICE)
        again_tpu = _strip(_obtain(job, True))
        cpu = _strip(_obtain(job, False))
        events = job.drain_accel_events()
        return (again_tpu, cpu, [(e["kind"], e["failure_class"],
                                  e["tpu_failures"], e["task_id"],
                                  e["attempt_id"]) for e in events],
                job.drain_accel_events(), _state(job))

    again_tpu, cpu, events, drained_twice, state = _both(case)
    assert again_tpu is None and cpu == (0, 1, False)
    assert [e[:2] for e in events] == [("tip_demoted", DEVICE)]
    assert drained_twice == []
    assert state[0]["tpu_demoted_tips"] == 1
    assert state[1]["tpumr.JobCounter"]["TPU_DEMOTIONS"] == 1


@pytest.mark.parametrize("failure_class", [COMPILE, USER, OOM, TIMEOUT, ""])
def test_only_accelerator_classes_demote(failure_class):
    """test_compile_failures_demote_too and
    test_user_and_unclassified_failures_do_not_demote."""
    def case(pkg):
        job = _job(pkg, n_maps=1)
        _fail(pkg, job, _obtain(job, True)[3], failure_class)
        return _strip(_obtain(job, True)), _state(job)

    again, state = _both(case)
    if failure_class == COMPILE:
        assert again is None
    else:
        assert again == (0, 1, True)
        assert "TPU_DEMOTIONS" not in state[1].get("tpumr.JobCounter", {})


def test_cpu_failures_never_demote():
    def case(pkg):
        job = _job(pkg, n_maps=1)
        _fail(pkg, job, _obtain(job, False)[3], DEVICE, on_tpu=False)
        return _strip(_obtain(job, True)), _state(job)

    again, _ = _both(case)
    assert again == (0, 1, True)


def test_retries_knob_allows_more_accelerator_attempts():
    def case(pkg):
        job = _job(pkg, n_maps=1, **{"tpumr.tpu.attempt.retries": 2})
        seq = []
        for _ in range(2):
            t = _obtain(job, True)
            seq.append(_strip(t))
            _fail(pkg, job, t[3], DEVICE)
        seq.append(_strip(_obtain(job, True)))
        return seq, _state(job)

    seq, state = _both(case)
    assert seq == [(0, 0, True), (0, 1, True), None]
    assert state[2] == [2]


def test_demoted_map_keeps_its_attempt_budget_for_the_cpu():
    def case(pkg):
        job = _job(pkg, n_maps=1, **{"mapred.map.max.attempts": 3})
        _fail(pkg, job, _obtain(job, True)[3], DEVICE)
        mid = (job.state, job.maps[0].failures)
        _finish(pkg, job, _obtain(job, False)[3])
        return mid, job.maps[0].state, _state(job)

    mid, tip_state, _ = _both(case)
    assert mid == ("RUNNING", 1) and tip_state == "succeeded"


def test_distinct_maps_quarantine_the_job():
    """TestJobTpuQuarantine::test_distinct_tips_disable_the_tpu_pass."""
    def case(pkg):
        job = _job(pkg, n_maps=4, **{"tpumr.tpu.job.quarantine.tips": 3})
        for _ in range(3):
            _fail(pkg, job, _obtain(job, True)[3], DEVICE)
        after = (_strip(_obtain(job, True)), _strip(_obtain(job, False)))
        kinds = [e["kind"] for e in job.drain_accel_events()]
        return after, kinds, _state(job)

    after, kinds, state = _both(case)
    assert after == (None, (0, 1, False))
    assert kinds.count("job_tpu_quarantined") == 1
    assert state[0]["tpu_disabled"] is True and state[4] is False


def test_one_map_failing_again_and_again_is_not_a_quarantine():
    def case(pkg):
        job = _job(pkg, n_maps=4, **{"tpumr.tpu.job.quarantine.tips": 3,
                                     "tpumr.tpu.attempt.retries": 10,
                                     "mapred.map.max.attempts": 20})
        for _ in range(5):
            _fail(pkg, job, _obtain(job, True)[3], DEVICE)
        return _state(job)

    assert _both(case)[0]["tpu_disabled"] is False


def test_profile_unwound_and_factor_reset():
    """test_profile_sums_unwound_and_factor_reset: after a quarantine the
    factor is 1.0, and an accelerator completion that arrives late counts
    as a finished map in neither profile."""
    def case(pkg):
        job = _job(pkg, n_maps=5, **{"tpumr.tpu.job.quarantine.tips": 3})
        _finish(pkg, job, _obtain(job, True)[3], runtime=1.0, on_tpu=True)
        _finish(pkg, job, _obtain(job, False)[3], runtime=4.0)
        before = job.acceleration_factor()
        for _ in range(3):
            _fail(pkg, job, _obtain(job, True)[3], DEVICE)
        quarantined = _state(job)
        straggler = job.maps[4]
        job.update_task_status(pkg.TaskStatus(
            attempt_id=pkg.TaskAttemptID(straggler.task_id, 7), is_map=True,
            run_on_tpu=True, state=pkg.TaskState.SUCCEEDED,
            start_time=T0, finish_time=T0 + 0.5), "t:0")
        return before, quarantined, _state(job), job._tpu_time_sum, \
            job._cpu_time_sum

    before, quarantined, late, tpu_sum, cpu_sum = _both(case)
    assert before == pytest.approx(4.0)
    assert quarantined[0]["finished_tpu_maps"] == 0
    assert quarantined[0]["acceleration_factor"] == 1.0
    assert late[0]["finished_maps"] == quarantined[0]["finished_maps"] + 1
    assert late[0]["finished_tpu_maps"] == 0
    assert late[0]["finished_cpu_maps"] == 1
    assert tpu_sum == 0.0 and cpu_sum == pytest.approx(4.0)


def _tracker_status(cpu=3, tpu=1, busy_tpu=False):
    """One runner's status; ``busy_tpu``: its one accelerator slot is
    running a map."""
    return {"tracker_name": "tracker_0", "host": "h", "shuffle_port": 0,
            "max_cpu_map_slots": cpu, "max_tpu_map_slots": tpu,
            "max_reduce_slots": 0, "count_cpu_map_tasks": 0,
            "count_tpu_map_tasks": int(busy_tpu), "count_reduce_tasks": 0,
            "available_tpu_devices": [not busy_tpu] * tpu}


class _Manager:
    def __init__(self, jobs):
        self._jobs = jobs

    def running_jobs(self):
        return self._jobs

    def num_trackers(self):
        return 1

    def total_slots(self):
        return {"cpu": 3, "tpu": 1, "reduce": 0}


def _scheduler(pkg, jobs):
    sched = pkg.Hybrid()
    sched.configure(pkg.JobConf())
    sched.set_manager(_Manager(jobs))
    return sched


def _placed(tasks):
    return [(str(t.attempt_id.task.job), t.partition, bool(t.run_on_tpu))
            for t in tasks]


def test_quarantine_breaks_the_optional_scheduling_deadlock():
    """TestSchedulerQuarantineInteraction::
    test_optional_scheduling_deadlock_broken_by_quarantine: starved by the
    factor, then quarantined, the job's maps go to the CPU pass."""
    def case(pkg):
        job = _job(pkg, n_maps=8, **{
            "mapred.jobtracker.map.optionalscheduling": True})
        sched = _scheduler(pkg, [job])
        _finish(pkg, job, _obtain(job, True)[3], runtime=0.1, on_tpu=True)
        _finish(pkg, job, _obtain(job, False)[3], runtime=1.0)
        before = _placed(sched.assign_tasks(_tracker_status()))
        job.tpu_disabled = True
        after = _placed(sched.assign_tasks(_tracker_status()))
        return before, after

    before, after = _both(case)
    assert before and all(on_tpu for _j, _p, on_tpu in before)
    assert after and not any(on_tpu for _j, _p, on_tpu in after)


def test_demoted_maps_lift_the_starvation_and_minimize_floor():
    """scheduler.py:295-315: a job with demoted maps pending is never
    starved by optional scheduling, and under minimize keeps a CPU slot
    for each, though its factor would give the CPU nothing."""
    def case(pkg):
        out = []
        for extra in ({"mapred.jobtracker.map.optionalscheduling": True},
                      {"tpumr.scheduler.mode": "minimize"}):
            job = _job(pkg, n_maps=6, **extra)
            sched = _scheduler(pkg, [job])
            _finish(pkg, job, _obtain(job, True)[3], runtime=0.1,
                    on_tpu=True)
            _finish(pkg, job, _obtain(job, False)[3], runtime=10.0)
            starved = _placed(sched.assign_tasks(_tracker_status(
                busy_tpu=True)))
            _fail(pkg, job, _obtain(job, True)[3], DEVICE)
            pinned = job.cpu_pinned_pending_count()
            out.append((starved, pinned, _placed(sched.assign_tasks(
                _tracker_status(busy_tpu=True)))))
        return out

    (o_starved, o_pinned, o_fed), (m_starved, m_pinned, m_fed) = _both(case)
    assert o_starved == m_starved == [] and o_pinned == m_pinned == 1
    # optional scheduling: the whole CPU budget, the demoted map first
    assert [(p, on_tpu) for _j, p, on_tpu in o_fed] == [
        (2, False), (3, False), (4, False)]
    # minimize: the factor's share is 0, the floor one slot for map 2
    assert [(p, on_tpu) for _j, p, on_tpu in m_fed] == [(2, False)]


def test_accelerator_pass_skips_a_quarantined_job():
    """test_tpu_pass_skips_quarantined_job_for_next_in_queue."""
    def case(pkg):
        quarantined = pkg.JobInProgress(
            pkg.JobID("af", 1), {"tpumr.map.kernel": "sleep",
                                 "mapred.reduce.tasks": 0},
            [{"locations": []} for _ in range(4)])
        quarantined.tpu_disabled = True
        healthy = pkg.JobInProgress(
            pkg.JobID("af", 2), {"tpumr.map.kernel": "sleep",
                                 "mapred.reduce.tasks": 0},
            [{"locations": []} for _ in range(4)])
        healthy.start_time = quarantined.start_time + 1
        healthy.sched_anchor = healthy.start_time
        sched = _scheduler(pkg, [quarantined, healthy])
        return _placed(sched.assign_tasks(_tracker_status(cpu=0)))

    got = _both(case)
    assert len(got) == 1 and got[0][2] and got[0][0].endswith("_0002")


# ------------------------------------------------------- device health


def _drive_health(pkg):
    """TestTpuDeviceHealth's three cases with an injected probe and
    clock: the decisions in order."""
    out = []
    dh = pkg.TpuDeviceHealth(2, threshold=3, probe=lambda d: None,
                             probe_interval_s=3600)
    try:
        out.append([dh.record_failure(0), dh.record_failure(0)])
        dh.record_success(0)
        out.append([dh.record_failure(0) for _ in range(3)])
        out.append((dh.quarantined(), dh.is_quarantined(0),
                    dh.is_quarantined(1), dh.record_failure(0),
                    dh.quarantine_events))
    finally:
        dh.stop()
    sick = [True]
    probes = []

    def probe(d):
        probes.append(d)
        if sick[0]:
            raise RuntimeError("still dead")

    dh = pkg.TpuDeviceHealth(1, threshold=1, probe=probe,
                             probe_interval_s=1.0, probe_max_interval_s=4.0)
    try:
        out.append(dh.record_failure(0))
        backoffs = []
        for _ in range(4):
            at, backoff = dh._quarantined[0]
            backoffs.append(backoff)
            out.append(dh.probe_once(now=at))
        out.append((backoffs, dh.quarantined()))
        sick[0] = False
        at, _ = dh._quarantined[0]
        out.append((dh.probe_once(now=at), dh.quarantined(),
                    dh.restore_events, len(probes), dh.record_failure(0)))
    finally:
        dh.stop()
    dh = pkg.TpuDeviceHealth(1, threshold=0, probe=lambda d: None)
    out.append((dh.record_failure(0), dh.quarantined()))
    dh.stop()
    return out


def test_device_health_sequence_matches_jax():
    got = _both(_drive_health)
    assert got[1] == [False, False, True]
    assert got[2] == ([0], True, False, False, 1)
    assert got[-3] == ([1.0, 2.0, 4.0, 4.0], [0])
    assert got[-2] == ([0], [], 1, 5, True)
    assert got[-1] == (False, [])


def test_a_probe_that_never_returns_does_not_hold_the_heartbeat():
    """The probe runs on the health object's thread: while it hangs, the
    quarantine reads (what the heartbeat calls) answer, from another
    thread, before the probe is let go."""
    import threading
    entered, release = threading.Event(), threading.Event()
    reads = []

    def heartbeat_reads():
        reads.append((dh.quarantined(), dh.is_quarantined(0)))

    def hung(d):
        entered.set()
        release.wait(10)
        raise RuntimeError("card gone")

    dh = port_health.TpuDeviceHealth(1, threshold=1, probe=hung,
                                     probe_interval_s=0.05)
    try:
        assert dh.record_failure(0)
        assert entered.wait(5), "the probe thread never probed"
        reader = threading.Thread(target=heartbeat_reads)
        reader.start()
        reader.join(5)
        assert not release.is_set() and reads == [([0], True)]
    finally:
        release.set()
        dh.stop()
    assert not dh._thread.is_alive()


def test_default_probe_needs_the_card():
    """default_tpu_probe is a CUDA op: without a card it raises, so a card
    quarantined there stays out; the CPU runner's probe passes."""
    if torch.cuda.is_available():
        port_health.default_tpu_probe(0)
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            port_health.default_tpu_probe(0)
    port_health.cpu_probe(0)
