"""The port's process-isolated task attempts on its MiniMRCluster, on the
CPU: ``mapred/child.py`` over the umbilical, ``mapred/process_runner.py``,
and the node runner's gate, umbilical methods, reaper and memory manager.

Oracles: tests/test_process_isolation.py
(test_isolated_wordcount_runs_out_of_process,
test_crashing_mapper_fails_attempt_tracker_survives,
test_memory_bomb_killed_and_retried) and tests/test_accel_fault.py
(TestEndToEndHungTaskReap::test_hung_isolated_child_is_sigkilled_and_reaped,
:710), with the isolated reduce's fetch-failure report of
tests/test_fetch_failure.py's end-to-end case; each job's records are the
JAX package's LocalJobRunner's for the same input and mapper. The gate is
held against the JAX package's NodeRunner._isolate_in_process. The mapper
classes live in a module of their own, written for the test, which imports
no torch and no JAX, so a child starts in well under a second.

Left out: the launch through the setuid task-controller as another user
(:232-273): its sandbox needs a world-readable copy of the package and a
build of native/task-controller, seconds more than this file's budget; the
route itself (the runner's conf names the controller) is
``process_runner.build_child_command``'s. Userlogs are not served
(:275-372), so nothing here reads them.
"""

import os
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import pytest

from tpumr.mapred.jobconf import JobConf as JaxJobConf
from tpumr.mapred.local_runner import LocalJobRunner as JaxLocal
from tpumr.mapred.task import Task as JaxTask
from tpumr.mapred.tasktracker import NodeRunner as JaxNodeRunner
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.mapred.ids import JobID, TaskAttemptID, TaskID
from tpumr_torch.mapred.job_client import JobClient
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.mapred.node_health import GLOBAL_MEMORY_MANAGER
from tpumr_torch.mapred.task import Task, TaskState
from tpumr_torch.mapred.tasktracker import NodeRunner
from tpumr_torch.utils import fi

#: seconds any one job may take here
JOB_TIMEOUT = 60
MODULE = "isolation_probe"

#: the mappers and reducer, importable by the children by name
PROBE = '''
import os
import subprocess
import time


class PidWordCountMapper:
    """Wordcount that counts the pid that ran it."""

    def configure(self, conf):
        pass

    def map(self, key, value, output, reporter):
        reporter.incr_counter("pids", f"pid_{os.getpid()}")
        for w in value.split():
            output.collect(w, 1)

    def close(self):
        pass


class SumReducer:
    def configure(self, conf):
        pass

    def reduce(self, key, values, output, reporter):
        output.collect(key, sum(values))

    def close(self):
        pass


class EchoMapper:
    """Each line once; the subclasses misbehave on attempt 0 only."""

    def configure(self, conf):
        self.conf = conf
        self.first = str(conf.get("tpumr.task.attempt.id", "")).endswith("_0")

    def map(self, key, value, output, reporter):
        output.collect(value, 1)

    def close(self):
        pass


class CrashMapper(EchoMapper):
    def map(self, key, value, output, reporter):
        if self.first:
            os._exit(66)
        super().map(key, value, output, reporter)


class MemoryBombMapper(EchoMapper):
    def map(self, key, value, output, reporter):
        if self.first:
            hog = [bytearray(16 << 20) for _ in range(24)]   # 384 MB
            for h in hog:
                h[::4096] = b"x" * len(h[::4096])
            time.sleep(30)
        super().map(key, value, output, reporter)


class HangMapper(EchoMapper):
    """Attempt 0 starts a grandchild, writes both pids, then sleeps
    without a word to its runner and without polling its kill flag."""

    def map(self, key, value, output, reporter):
        if self.first:
            grandchild = subprocess.Popen(["sleep", "60"])
            with open(self.conf.get("test.pid.file"), "w") as f:
                f.write(f"{os.getpid()} {grandchild.pid}")
            time.sleep(60)
        super().map(key, value, output, reporter)
'''

TEXT = b"alpha beta\nbeta gamma\n" * 50


@pytest.fixture(scope="module")
def probe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("probe")
    (d / f"{MODULE}.py").write_text(textwrap.dedent(PROBE))
    (d / "in.txt").write_bytes(TEXT)
    sys.path.insert(0, str(d))
    try:
        yield d
    finally:
        sys.path.remove(str(d))
        sys.modules.pop(MODULE, None)


@pytest.fixture(scope="module")
def cluster(probe_dir):
    # the JAX package's memory samplers are also named "task-memory" and
    # never end: a worker that ran its tests earlier holds one for good,
    # so only the samplers started from here on must end
    samplers = {t for t in threading.enumerate() if t.name == "task-memory"}
    base = JobConf()
    base.set(DEVICE_KEY, "cpu")
    base.set("tpumr.task.isolation", "process")
    base.set("mapred.map.max.attempts", 3)
    # one runner takes every failure these tests make on purpose: it must
    # not be blacklisted (the JAX package's fixture has two runners)
    base.set("tpumr.tracker.max.faults", 1000)
    c = MiniMRCluster(num_trackers=1, cpu_slots=2, tpu_slots=0, conf=base)
    try:
        yield c
    finally:
        c.shutdown()
    assert _eventually(lambda: _threads() == [])
    assert _eventually(lambda: not [t for t in threading.enumerate()
                                    if t.name == "task-memory"
                                    and t not in samplers])


def _threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("heartbeat-", "task-", "rpc-server",
                                  "jobmaster-", "pipes-"))]


def _eventually(cond, timeout: float = 5.0) -> bool:
    """``cond()`` within ``timeout`` s: a child's exit is reaped a moment
    after its last report."""
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


def _alive(pid: int) -> bool:
    """Running, not a zombie waiting for a parent that is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except OSError:
        return False


def _read_parts(out_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("part-"):
            for line in (out_dir / name).read_text().splitlines():
                k, v = line.split("\t")
                out[k] = int(v)
    return out


def _reference(probe_dir, tmp_path, mapper: str, reducer: "str | None"):
    """The JAX package's LocalJobRunner on the same input and classes."""
    conf = JaxJobConf()
    conf.set_input_paths(f"file://{probe_dir}/in.txt")
    conf.set_output_path(f"file://{tmp_path}/ref")
    conf.set("mapred.mapper.class", f"{MODULE}.{mapper}")
    if reducer:
        conf.set("mapred.reducer.class", f"{MODULE}.{reducer}")
    conf.set_num_reduce_tasks(1)
    assert JaxLocal(conf).submit_job(conf).successful
    return _read_parts(tmp_path / "ref")


def _job(cluster, probe_dir, tmp_path, mapper: str,
         reducer: "str | None" = None, reduces: int = 1, **keys):
    conf = cluster.create_job_conf()
    conf.set_input_paths(f"file://{probe_dir}/in.txt")
    conf.set_output_path(f"file://{tmp_path}/out")
    conf.set("mapred.min.split.size", 1)
    conf.set("mapred.map.tasks", 2)
    conf.set("mapred.mapper.class", f"{MODULE}.{mapper}")
    if reducer:
        conf.set("mapred.reducer.class", f"{MODULE}.{reducer}")
    conf.set_num_reduce_tasks(reduces)
    for k, v in keys.items():
        conf.set(k, v)
    return conf


def _run(cluster, conf):
    """Submit and wait: (status, the job's master-side record)."""
    client = JobClient(conf)
    try:
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=JOB_TIMEOUT)
        counters = running.counters()
    finally:
        client.close()
    return st, cluster.master.jobs[running.job_id], counters


def _failed(jip):
    return [a for tip in jip.maps for a in tip.attempts.values()
            if a.state == TaskState.FAILED]


def test_isolated_wordcount_runs_out_of_process(cluster, probe_dir,
                                                tmp_path):
    """test_isolated_wordcount_runs_out_of_process: no map ran in this
    (the runner's) process, and the counts are the JAX package's."""
    want = _reference(probe_dir, tmp_path, "PidWordCountMapper",
                      "SumReducer")
    st, _jip, counters = _run(cluster, _job(
        cluster, probe_dir, tmp_path, "PidWordCountMapper", "SumReducer"))
    assert st["state"] == "SUCCEEDED", st
    assert _read_parts(tmp_path / "out") == want == \
        {"alpha": 50, "beta": 100, "gamma": 50}
    pids = counters.to_dict().get("pids", {})
    assert len(pids) == 2 and f"pid_{os.getpid()}" not in pids
    assert _eventually(
        lambda: cluster.trackers[0].metrics()["task_children"] == {})


def test_crashing_mapper_fails_attempt_tracker_survives(cluster, probe_dir,
                                                        tmp_path):
    """test_crashing_mapper_fails_attempt_tracker_survives: os._exit in
    attempt 0 fails that attempt (class user, the exit code in its
    diagnostics); the one runner lives on and runs the retries."""
    want = _reference(probe_dir, tmp_path, "EchoMapper", None)
    st, jip, _ = _run(cluster, _job(cluster, probe_dir, tmp_path,
                                    "CrashMapper"))
    assert st["state"] == "SUCCEEDED", st
    assert _read_parts(tmp_path / "out") == want
    failed = _failed(jip)
    assert len(failed) == 2
    assert {a.failure_class for a in failed} == {"user"}
    assert all("rc=66" in a.diagnostics for a in failed)
    tracker = cluster.trackers[0]
    assert tracker.heartbeat_error == "" and tracker._hb_thread.is_alive()


def test_memory_bomb_killed_and_retried(cluster, probe_dir, tmp_path):
    """test_memory_bomb_killed_and_retried: the node's memory manager
    kills attempt 0's child above ``mapred.task.limit.maxrss.mb`` (a
    child here holds about 40 MB before the bomb's 384), class oom; the
    retries finish the job."""
    want = _reference(probe_dir, tmp_path, "EchoMapper", None)
    before = len(GLOBAL_MEMORY_MANAGER.killed)
    st, jip, _ = _run(cluster, _job(cluster, probe_dir, tmp_path,
                                    "MemoryBombMapper",
                                    **{"mapred.task.limit.maxrss.mb": 200}))
    assert st["state"] == "SUCCEEDED", st
    assert _read_parts(tmp_path / "out") == want
    assert len(GLOBAL_MEMORY_MANAGER.killed) - before == 2
    failed = _failed(jip)
    assert len(failed) == 2 and {a.failure_class for a in failed} == {"oom"}
    assert _eventually(lambda: GLOBAL_MEMORY_MANAGER.watching() == [])


def test_hung_isolated_child_is_sigkilled_and_reaped(cluster, probe_dir,
                                                     tmp_path):
    """TestEndToEndHungTaskReap::test_hung_isolated_child_is_sigkilled_
    and_reaped: the hung child keeps pinging and pushing an unchanging
    status, is reaped at ``mapred.task.timeout`` (class timeout), and its
    process group is SIGKILLed, its grandchild too; the re-run finishes
    the job."""
    want = _reference(probe_dir, tmp_path, "EchoMapper", None)
    pid_file = tmp_path / "pids"
    conf = _job(cluster, probe_dir, tmp_path, "HangMapper",
                **{"mapred.task.timeout": 2000, "test.pid.file":
                   str(pid_file), "mapred.map.tasks": 1})
    t0 = time.monotonic()
    st, jip, counters = _run(cluster, conf)
    assert st["state"] == "SUCCEEDED", st
    assert time.monotonic() - t0 < 20
    assert _read_parts(tmp_path / "out") == want
    failed = _failed(jip)
    assert len(failed) == 1 and failed[0].failure_class == "timeout"
    assert "failed to report status" in failed[0].diagnostics
    child, grandchild = map(int, pid_file.read_text().split())
    assert child != os.getpid()
    assert _eventually(lambda: not _alive(child) and not _alive(grandchild))
    assert cluster.trackers[0].metrics()["tasks_reaped_timeout"] == 1


def test_isolated_reduce_reports_fetch_failures(cluster, probe_dir,
                                                tmp_path):
    """The end-to-end lost-output case of tests/test_fetch_failure.py with
    the reduce in a child: every map's first output cannot be served
    (``tpumr.fi.shuffle.serve.a0``), the reduce reports it up the
    umbilical (``umbilical_report_fetch_failure``), the master re-executes
    each map once, and the reduce succeeds on its first attempt."""
    want = _reference(probe_dir, tmp_path, "PidWordCountMapper",
                      "SumReducer")
    tracker = cluster.trackers[0]
    reports = []
    real = tracker.umbilical_report_fetch_failure

    def counted(reduce_attempt, map_attempt):
        reports.append((reduce_attempt, map_attempt))
        return real(reduce_attempt, map_attempt)

    tracker.umbilical_report_fetch_failure = counted
    fi.reset()
    try:
        st, jip, _ = _run(cluster, _job(
            cluster, probe_dir, tmp_path, "PidWordCountMapper", "SumReducer",
            **{"tpumr.fi.shuffle.serve.a0.probability": 1.0,
               "tpumr.shuffle.fetch.retries.per.source": 1,
               "tpumr.shuffle.copy.backoff.ms": 10,
               "tpumr.shuffle.copy.backoff.max.ms": 100,
               "mapred.max.fetch.failures.per.map": 1}))
        fired = fi.fired("shuffle.serve.a0")
    finally:
        del tracker.umbilical_report_fetch_failure
        fi.reset()
    assert st["state"] == "SUCCEEDED", st
    assert _read_parts(tmp_path / "out") == want
    assert fired >= 2
    assert {m for _r, m in reports} == {
        str(a.attempt_id) for tip in jip.maps
        for a in tip.attempts.values() if a.attempt_id.attempt == 0}
    assert {r for r, _m in reports} == {
        str(a.attempt_id) for tip in jip.reduces
        for a in tip.attempts.values()}
    assert [t.failures for t in jip.maps] == [1, 1]
    assert [t.failures for t in jip.reduces] == [0]


ISO = {"tpumr.task.isolation": "process"}


@pytest.mark.parametrize("case", [
    ("cpu map", True, False, ISO, True),
    ("gpu map", True, True, ISO, False),
    ("reduce", False, False, ISO, True),
    ("gang reduce", False, False, dict(ISO, **{"tpumr.shuffle.device": True}),
     False),
    ("runner conf", True, False, {}, True),
    ("off", True, False, {"tpumr.task.isolation": "thread"}, False)],
    ids=lambda c: c[0])
def test_gate_keeps_accelerator_and_gang_attempts_in_the_runner(case):
    """NodeRunner._isolate_in_process (tpumr/mapred/tasktracker.py:1542-
    1557), on both packages (the runner's conf asks for processes): the
    job's ``tpumr.task.isolation`` first, then the runner's; never an
    accelerator-slot attempt or a device-shuffled job's gang reduce."""
    from tpumr.mapred import ids as jax_ids
    _label, is_map, on_gpu, keys, want = case
    got = {}
    for pkg, conf_cls, runner_cls, ids, task_cls in (
            ("port", JobConf, NodeRunner, (JobID, TaskID, TaskAttemptID),
             Task),
            ("jax", JaxJobConf, JaxNodeRunner,
             (jax_ids.JobID, jax_ids.TaskID, jax_ids.TaskAttemptID),
             JaxTask)):
        jid, tid, aid = ids
        job_conf = conf_cls()
        for k, v in keys.items():
            job_conf.set(k, v)
        runner = SimpleNamespace(conf=conf_cls())
        runner.conf.set("tpumr.task.isolation", "process")
        task = task_cls(aid(tid(jid("j", 1), is_map, 0), 0), partition=0,
                        run_on_tpu=on_gpu, tpu_device_id=0 if on_gpu else -1)
        got[pkg] = runner_cls._isolate_in_process(runner, job_conf, task)
    assert got == {"port": want, "jax": want}
