"""The job master: job table, node-runner registry, heartbeats and the
scheduler, served over RPC.

Counterpart of ``JobMaster`` in ``tpumr/mapred/jobtracker.py``. A node
runner's heartbeat (:meth:`JobMaster.heartbeat`, ``:2460`` there) carries
its slots, its free device ids and its attempts' statuses; the master
folds the statuses into each job (``JobInProgress.update_task_status``,
which sums each backend's map runtimes), replays the stored actions when a
response was lost (same ``response_id`` echoed back), asks the scheduler
for work when the runner has a free slot, and answers with launch, kill
and job-cleanup actions. A runner whose heartbeats stop for
``tpumr.tracker.expiry.ms`` is dropped, and its running attempts and
served map outputs are requeued. When a job's last task finishes, the
master commits its output (``FileOutputCommitter.commit_job``, or
``abort_job`` for a failed or killed job) outside the heartbeat's locks,
and only then shows clients the terminal state. It also grants each task's
commit to the first attempt that asks (:meth:`can_commit`).

A heartbeat's ``fetch_failures`` (``:2867-2868``), the reports of the
runner's reduces that a map attempt's output cannot be fetched, go to the
job's ``fetch_failure_notification``; where the job withdraws the output
and re-executes the map, the burned attempt's commit grant is revoked
(:meth:`JobMaster._fetch_failure`).

Accelerator faults (``:414-420, 2780-2850, 2944, 3036-3050``): each folded
job's demotion and quarantine decisions are drained
(``JobInProgress.drain_accel_events``) into the master's metrics
(``tpu_demotions``, ``jobs_tpu_quarantined``); an attempt a runner reaped
(FAILED, class ``timeout``) counts once in its job's
``TASKS_REAPED_TIMEOUT`` and in ``tasks_reaped_timeout``, however often a
beat carrying it is replayed. A runner whose health script reports it
unhealthy gets no task; :meth:`JobMaster.get_active_trackers` names it
with the script's report. :meth:`JobMaster.get_metrics` serves the
counts, with the cards quarantined across the runners.

RPC methods: ``submit_job(conf_dict, splits)`` (``:1326``),
``heartbeat(status, initial_contact, ask_for_new_task, response_id)``,
``get_job_status`` (``:1636``), ``get_counters``, ``get_task_reports``,
``get_map_completion_events`` (``:1893``), ``get_job_conf``,
``can_commit`` (``:2373``), ``kill_job``, ``kill_task`` (``:1724``),
``set_job_priority`` (``:1700``), ``get_attempt_ids`` (``:1748``),
``list_jobs`` (``:1503``), ``get_active_trackers`` (``:1773``),
``get_blacklisted_trackers`` (``:1792``), ``get_recovered_jobs``
(``:735``), ``get_metrics`` and ``get_protocol_version``. The master is the scheduler's
``TaskTrackerManager`` (``running_jobs``, ``num_trackers``,
``total_slots``).

Pipelines (``:1967-2133, 2159-2347, 3221``): ``submit_pipeline(graph)``
validates a ``JobGraph``'s wire form, refuses a conf hook outside the
prefixes of ``tpumr.pipeline.conf.hooks.allowed`` (default
``tpumr_torch.``: the JAX package's default, ``tpumr.``, admits no hook of
the port), and submits the source stages before it returns. The
``jobmaster-pipeline`` thread advances every running pipeline when a
heartbeat or a job's commit wakes it, and every 0.5 s otherwise:
:meth:`JobMaster._submit_stage` builds each due stage outside the pipeline
lock (its round's conf, the dfs inputs or the handoff splits of a streamed
stage, the conf hook, then ``job_client.build_submission``, the helper the
client uses). ``get_pipeline_status``, ``list_pipelines``,
``kill_pipeline``, ``get_handoff_completion_events`` and
``handoff_purgeable`` serve clients and runners. A lost runner's handoff
announcements are withdrawn with its map outputs.

The master's state (``:118-180, 285-300, 602-760, 1636-1875, 2347-2370,
2697-2841``):

- job history (``mapred/history.py``, ``tpumr.history.dir``): each
  submission with its whole conf and splits, each attempt's start and end
  (with its runner, serving address, backend, runtime and counters), each
  withdrawn output (``MAP_OUTPUT_LOST``), the demotion and quarantine
  decisions (``TIP_TPU_DEMOTED``, ``JOB_TPU_QUARANTINED``), priority
  changes and operator kills, and one ``JOB_FINISHED`` a job, with its
  stats rollup; a pipeline's submission, stage submissions and end in the
  pipeline's own file. A heartbeat's events are written after its locks,
  before the jobs it ended are finalised;
- restart recovery (``mapred.jobtracker.restart.recover``), run in
  :meth:`JobMaster.start` before the RPC server takes its first call:
  each job that history shows submitted and not ended is resubmitted under
  a new id, its finished attempts replayed
  (``JobInProgress.recover_attempts``), its tasks held back for
  ``mapred.jobtracker.restart.recovery.grace.ms`` (default 3,000) so that
  the runners still running its attempts rejoin first; the old id is an
  alias of the new one wherever an id comes off the wire
  (:meth:`JobMaster._resolve_job`, :meth:`JobMaster.get_recovered_jobs`);
  then each pipeline not ended is rebuilt
  (``PipelineInProgress.from_recovery``). A job that ended before the
  restart is served from its log (:meth:`JobMaster._retired_status`);
- a runner the master does not know that sends a beat that is not an
  initial contact is rejoining: it is registered, its running attempts
  adopted (``JobInProgress.adopt_running_attempt``), the ones no job
  takes killed one by one, and it is told each recovered job's new id
  (``recover_job`` actions), never reset;
- blacklisting: a FAILED attempt charges one fault to its runner, and an
  output withdrawn for fetch failures charges one to the runner that
  served it; at ``tpumr.tracker.max.faults`` (default 4) the runner is
  blacklisted and gets no task (:meth:`JobMaster.get_blacklisted_trackers`);
- speculative twins that lost and operator kills
  (:meth:`JobMaster.kill_task`) go out as kill actions;
  :meth:`JobMaster.set_job_priority` changes a job's priority, and a
  restart replays the change.

Left out (``ROADMAP.md``): tracing and the metrics registry (the port keeps
the counts of :meth:`JobMaster.get_metrics` only), the history server, the
sharded tracker registry and lock ranks, ACLs, queues and tokens, the HTTP
pages, the heartbeat delta encoding, brownout, and host include and
exclude lists.
"""

from __future__ import annotations

import importlib
import json
import logging
import threading
import time
from typing import Any

from tpumr_torch.core.counters import JobCounter
from tpumr_torch.ipc.rpc import RpcServer
from tpumr_torch.mapred.history import JobHistory
from tpumr_torch.mapred.ids import JobID, TaskAttemptID
from tpumr_torch.mapred.job_in_progress import (JobInProgress, JobState,
                                                normalize_priority)
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.scheduler import HybridQueueScheduler
from tpumr_torch.mapred.task import FailureClass, TaskState, TaskStatus
from tpumr_torch.pipeline.graph import JobGraph
from tpumr_torch.pipeline.handoff import build_handoff_splits
from tpumr_torch.pipeline.pipeline_in_progress import (PipelineInProgress,
                                                       PipelineState)
from tpumr_torch.utils.reflection import new_instance

PROTOCOL_VERSION = 29
#: seconds ``stop`` waits for each of the master's threads
JOIN_TIMEOUT_S = 5.0
#: the pipeline thread's poll when nothing wakes it
PIPELINE_POLL_S = 0.5
#: default of ``tpumr.pipeline.conf.hooks.allowed`` in the port
HOOKS_ALLOWED_DEFAULT = "tpumr_torch."
#: the counts :meth:`JobMaster.get_metrics` serves, under the JAX
#: package's metric names
METRIC_NAMES = ("tpu_demotions", "jobs_tpu_quarantined",
                "tasks_reaped_timeout", "jobs_recovered",
                "jobs_recovery_failed", "attempts_recovered",
                "attempts_adopted", "trackers_adopted",
                "trackers_restarted", "maps_launched_cpu",
                "maps_launched_tpu", "reduces_launched",
                "fetch_failures_reported", "maps_reexecuted_fetch_failure",
                "pipelines_recovered", "pipelines_recovery_failed")

_log = logging.getLogger(__name__)


class _TrackerInfo:
    def __init__(self, status: dict) -> None:
        self.status = status
        self.seen_mono = time.monotonic()
        #: serialises this runner's heartbeats end to end
        self.lock = threading.Lock()
        #: attempts the master believes run there (launches and statuses)
        self.running: "set[str]" = set()
        #: jobs that ran tasks there and have not been cleaned up
        self.jobs: "set[str]" = set()
        #: blacklist faults (failed attempts, outputs lost to fetch
        #: failures); charged from other runners' beats too
        self.failures = 0
        self.blacklisted = False
        self._fault_lock = threading.Lock()

    def shuffle_addr(self) -> str:
        st = self.status
        return st.get("shuffle_addr") or \
            f"{st.get('host', '')}:{st.get('shuffle_port', 0)}"

    def charge_fault(self, limit: int) -> bool:
        """One fault; True when it blacklisted the runner."""
        with self._fault_lock:
            self.failures += 1
            if self.failures >= limit and not self.blacklisted:
                self.blacklisted = True
                return True
            return False


class JobMaster:
    def __init__(self, conf: Any, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.conf = conf
        #: guards the job table, the tracker registry and commit grants
        self.lock = threading.RLock()
        #: one scheduler pass at a time
        self.sched_lock = threading.Lock()
        self.jobs: "dict[str, JobInProgress]" = {}
        self.trackers: "dict[str, _TrackerInfo]" = {}
        #: runner name -> (response id, actions) of the last response
        self._last_response: "dict[str, tuple[int, list]]" = {}
        self._commit_grants: "dict[str, str]" = {}   # task id -> attempt
        #: old job id -> the id this master resubmitted it as; written
        #: before the RPC server starts, read without a lock after
        self._recovered: "dict[str, str]" = {}
        self._next_job = 0
        # differs across restarts, so that a recovered job's new id never
        # names the old job's history file
        self.cluster_id = str(int(time.time() * 1000))
        self.expiry_s = conf.get_int("tpumr.tracker.expiry.ms",
                                     10_000) / 1000.0
        self.blacklist_faults = conf.get_int("tpumr.tracker.max.faults", 4)
        self.scheduler = new_instance(
            conf.get_class("mapred.jobtracker.taskScheduler",
                           HybridQueueScheduler), conf)
        self.scheduler.set_manager(self)
        self.history = JobHistory(conf)
        #: pipeline id -> its state; guarded by ``_pipe_lock``
        self.pipelines: "dict[str, PipelineInProgress]" = {}
        #: ids of the pipelines still running: the only ones the pipeline
        #: thread walks, and while there are none it is not woken
        self._running_pipes: "set[str]" = set()
        self._pipe_lock = threading.Lock()
        self._next_pipe = 0
        self._pipe_wake = threading.Event()
        #: the counts :meth:`get_metrics` serves
        self._metrics = dict.fromkeys(METRIC_NAMES, 0)
        self._server = RpcServer(self, host, port)
        self._stop = threading.Event()
        self._expire_thread = threading.Thread(
            target=self._expire_loop, name="jobmaster-expiry", daemon=True)
        self._pipe_thread = threading.Thread(
            target=self._pipeline_loop, name="jobmaster-pipeline",
            daemon=True)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "JobMaster":
        # recovery first: a rejoining runner's first beat must find the
        # recovered jobs and their aliases, or its attempts are killed
        if self.conf.get_boolean("mapred.jobtracker.restart.recover", False):
            self._recover_jobs()
            # after the jobs: stage ids follow the finished alias table
            self._recover_pipelines()
        self._server.start()
        self._expire_thread.start()
        self._pipe_thread.start()
        return self

    def stop(self) -> None:
        """Stop serving and the threads; the history log is whole on disk
        when this returns. Running jobs are not finalised (a restart with
        recovery resumes them)."""
        self._stop.set()
        self._pipe_wake.set()
        self._server.stop()
        for t in (self._expire_thread, self._pipe_thread):
            if t.is_alive():
                t.join(JOIN_TIMEOUT_S)
        self.history.stop()

    @property
    def address(self) -> tuple[str, int]:
        return self._server.address

    # ------------------------------------------------------------ recovery

    def _recover_jobs(self) -> None:
        """Resubmit each job that history shows submitted and not ended,
        replay its finished attempts, hold its tasks for the grace, and
        keep its old id as an alias of the new one."""
        grace_s = self.conf.get_int(
            "mapred.jobtracker.restart.recovery.grace.ms", 3000) / 1000.0
        for ev in self.history.incomplete_jobs():
            old_id = ev["job_id"]
            if ev.get("conf_dropped"):
                # keys lost to serialisation: every task would fail
                self._count("jobs_recovery_failed")
                self.history.task_event(
                    old_id, "JOB_RECOVERY_FAILED",
                    error=f"non-serializable conf keys: "
                          f"{ev['conf_dropped']}")
                continue
            try:
                new_id = self._submit_job(ev["conf"], ev["splits"])
            except Exception as e:  # noqa: BLE001 — the others go on
                self._count("jobs_recovery_failed")
                self.history.task_event(old_id, "JOB_RECOVERY_FAILED",
                                        error=str(e))
                continue
            jip = self.jobs[new_id]
            recovered = 0
            try:
                recovered = jip.recover_attempts(
                    self.history.recovered_attempt_state(old_id), old_id)
            except Exception:  # noqa: BLE001 — a failed replay only means
                _log.exception("replaying %s failed", old_id)  # re-runs
            if grace_s > 0:
                jip.schedule_hold_until = time.monotonic() + grace_s
            self._recovered[old_id] = new_id
            self.history.job_recovered(old_id, new_id)
            self._count("jobs_recovered")
            if recovered:
                self._count("attempts_recovered", recovered)
                self.history.task_event(
                    new_id, "JOB_ATTEMPTS_RECOVERED", from_job=old_id,
                    attempts=recovered)
            if jip.state in JobState.TERMINAL:
                # every task had ended before the old master committed
                self._finalize_job(jip)

    def _recover_pipelines(self) -> None:
        """Rebuild each pipeline not ended from its journal; stages that
        ended before the restart are never run again."""
        for rec in self.history.incomplete_pipelines():
            pid = rec["pipeline_id"]
            try:
                pip = PipelineInProgress.from_recovery(
                    pid, rec["graph"], rec["stages"], self,
                    user=rec.get("user", ""))
            except Exception as e:  # noqa: BLE001 — the others go on
                self._count("pipelines_recovery_failed")
                self.history.task_event(pid, "PIPELINE_RECOVERY_FAILED",
                                        error=str(e))
                continue
            with self._pipe_lock:
                self.pipelines[pid] = pip
                self._running_pipes.add(pid)
            self._count("pipelines_recovered")
            self.history.task_event(pid, "PIPELINE_RECOVERED",
                                    pipeline_id=pid)

    def _resolve_job(self, job_id: str) -> "JobInProgress | None":
        """A job by its id or by the id it had before a restart."""
        jip = self.jobs.get(job_id)
        if jip is None and self._recovered:
            jip = self.jobs.get(self._recovered.get(job_id, ""))
        return jip

    def get_recovered_jobs(self) -> dict:
        """old job id -> the id this master recovered it as."""
        return dict(self._recovered)

    # ------------------------------------------------------------ manager

    def running_jobs(self) -> "list[JobInProgress]":
        with self.lock:
            return [j for j in self.jobs.values()
                    if j.state == JobState.RUNNING]

    def num_trackers(self) -> int:
        with self.lock:
            return max(1, sum(1 for t in self.trackers.values()
                              if not t.blacklisted))

    def get_active_trackers(self) -> "list[str]":
        """The runners' names but the blacklisted; an unhealthy one
        followed by a tab and ``UNHEALTHY: <the health script's report>``.
        """
        out = []
        with self.lock:
            for name in sorted(self.trackers):
                t = self.trackers[name]
                if t.blacklisted:
                    continue
                st = t.status or {}
                if st.get("healthy", True):
                    out.append(name)
                else:
                    reason = st.get("health_report", "") or "unhealthy"
                    out.append(f"{name}\tUNHEALTHY: {reason}")
        return out

    def get_blacklisted_trackers(self) -> "list[str]":
        with self.lock:
            return sorted(n for n, t in self.trackers.items()
                          if t.blacklisted)

    def get_metrics(self) -> dict:
        """The counts since the start (``METRIC_NAMES``), and the cards
        quarantined and the runners blacklisted now."""
        with self.lock:
            out = dict(self._metrics)
            out["tpu_devices_quarantined"] = sum(
                len(t.status.get("quarantined_tpu_devices") or [])
                for t in self.trackers.values())
            out["trackers_blacklisted"] = sum(
                1 for t in self.trackers.values() if t.blacklisted)
            out["history_writes_dropped"] = self.history.writes_dropped
        return out

    def _count(self, key: str, n: int = 1) -> None:
        with self.lock:
            self._metrics[key] += n

    def total_slots(self) -> dict:
        out = {"cpu": 0, "tpu": 0, "reduce": 0}
        with self.lock:
            infos = list(self.trackers.values())
        for t in infos:
            out["cpu"] += t.status.get("max_cpu_map_slots", 0)
            out["tpu"] += t.status.get("max_tpu_map_slots", 0)
            out["reduce"] += t.status.get("max_reduce_slots", 0)
        return out

    # ------------------------------------------------------------ RPC: jobs

    def get_protocol_version(self) -> int:
        return PROTOCOL_VERSION

    def submit_job(self, conf_dict: dict, splits: list) -> str:
        return self._submit_job(conf_dict, splits)

    def _submit_job(self, conf_dict: dict, splits: list,
                    pipeline: "PipelineInProgress | None" = None) -> str:
        with self.lock:
            self._next_job += 1
            job_id = JobID(self.cluster_id, self._next_job)
        jip = JobInProgress(job_id, conf_dict, splits)
        if pipeline is not None:
            # every stage of a pipeline sorts at the pipeline's submission
            jip.sched_anchor = pipeline.start_time
        with self.lock:
            self.jobs[str(job_id)] = jip
        # the conf and the splits, for a restarted master to resubmit
        self.history.job_submitted(jip)
        return str(job_id)

    def list_jobs(self) -> "list[str]":
        """Every job id the master knows, in order."""
        with self.lock:
            return sorted(self.jobs)

    def _job(self, job_id: str) -> JobInProgress:
        jip = self._resolve_job(job_id)
        if jip is None:
            raise KeyError(f"unknown job {job_id}")
        return jip

    def get_job_status(self, job_id: str) -> dict:
        """The job's status (``job_id`` is the current id, so that a
        client polling an old id learns the new one); a job that ended
        before a restart, from its history."""
        jip = self._resolve_job(job_id)
        if jip is None:
            st = self._retired_status(job_id)
            if st is None:
                raise KeyError(f"unknown job {job_id}")
            return st
        d = jip.status_dict()
        if d["state"] in JobState.TERMINAL and not jip.finalized.is_set():
            # commit or abort still running: the output is not there yet
            d["state"] = JobState.RUNNING
        return d

    def _retired_status(self, job_id: str) -> "dict | None":
        """A status served from history, following the chain of earlier
        restarts' ``JOB_RECOVERED`` markers a few hops."""
        for _ in range(8):
            st = self.history.retired_job_status(job_id)
            if st is None:
                return None
            successor = st.pop("recovered_as", None)
            if not successor:
                st.pop("_acl_conf", None)
                return st
            jip = self._resolve_job(successor)
            if jip is not None:
                return self.get_job_status(str(jip.job_id))
            job_id = successor
        return None

    def get_counters(self, job_id: str) -> dict:
        return self._job(job_id).counters.to_dict()

    def get_task_reports(self, job_id: str, kind: str = "map") -> list:
        jip = self._job(job_id)
        with jip.lock:
            tips = list(jip.maps if kind == "map" else jip.reduces)
            return [{
                "task_id": str(t.task_id), "state": t.report.state,
                "progress": t.report.progress,
                "start_time": t.report.start_time,
                "finish_time": t.report.finish_time,
                "run_on_tpu": t.report.run_on_tpu,
                "tpu_device_id": t.report.tpu_device_id,
                "successful_attempt": t.report.successful_attempt,
            } for t in tips]

    def get_map_completion_events(self, job_id: str, from_index: int = 0,
                                  max_events: int = 10_000) -> list:
        events, _pending = self._job(job_id).completion_events.read(
            int(from_index), int(max_events))
        return [dict(e) for e in events]

    def get_job_conf(self, job_id: str) -> dict:
        return dict(self._job(job_id).conf)

    def kill_job(self, job_id: str) -> bool:
        jip = self._job(job_id)
        if not jip.kill():
            return False
        self._finalize_job(jip)
        return True

    def set_job_priority(self, job_id: str, priority: str) -> str:
        """The job's new priority (the FIFO order sorts by it at the next
        pass); journaled, so that a restart keeps it. Returns the
        canonical name."""
        jip = self._job(job_id)
        p = normalize_priority(priority)   # raises on an unknown name
        with jip.lock:
            jip.priority = p
        self.history.task_event(str(jip.job_id), "JOB_PRIORITY_CHANGED",
                                priority=p, by="")
        return p

    def kill_task(self, attempt_id: str, should_fail: bool = False) -> bool:
        """Kill one running attempt at its runner's next heartbeat; with
        ``should_fail`` its end counts toward its task's attempt limit.
        False for an id that names no running attempt."""
        try:
            job_id = str(TaskAttemptID.parse(attempt_id).task.job)
        except (ValueError, KeyError, IndexError):
            return False
        jip = self._job(job_id)
        ok = jip.request_attempt_kill(attempt_id, fail=should_fail)
        if ok:
            self.history.task_event(
                str(jip.job_id), "TASK_KILL_REQUESTED",
                attempt_id=attempt_id, should_fail=should_fail, by="")
        return ok

    def get_attempt_ids(self, job_id: str, kind: str = "map",
                        state: str = "running") -> "list[str]":
        """The attempt ids of one task type, running or completed."""
        jip = self._job(job_id)
        if kind not in ("map", "reduce") \
                or state.lower() not in ("running", "completed"):
            raise ValueError(
                f"kind must be map|reduce and state running|completed "
                f"(got {kind!r}, {state!r})")
        want = (TaskState.RUNNING if state.lower() == "running"
                else TaskState.SUCCEEDED)
        with jip.lock:
            tips = jip.maps if kind == "map" else jip.reduces
            return sorted(aid for tip in tips
                          for aid, st in tip.attempts.items()
                          if st.state == want)

    def can_commit(self, task_id: str, attempt_id: str) -> bool:
        """The first attempt of a task to ask wins the commit; an attempt
        the master already settled is refused."""
        jip = None
        try:
            jip = self._resolve_job(
                str(TaskAttemptID.parse(attempt_id).task.job))
        except (ValueError, IndexError):
            pass
        if jip is not None:
            with jip.lock:
                tip = jip.tip_of_attempt(attempt_id)
                st = tip.attempts.get(attempt_id) if tip is not None \
                    else None
                if st is not None and st.state in TaskState.TERMINAL:
                    return False
        with self.lock:
            return self._commit_grants.setdefault(task_id,
                                                  attempt_id) == attempt_id

    def _revoke_commit(self, task_id: str, attempt_id: str) -> None:
        with self.lock:
            if self._commit_grants.get(task_id) == attempt_id:
                del self._commit_grants[task_id]

    def _finalize_job(self, jip: JobInProgress) -> None:
        """Commit (or abort) the job's output and write its end to history,
        once, then make its terminal state visible."""
        with jip.lock:
            if jip.finalize_started:
                return
            jip.finalize_started = True
        try:
            from tpumr_torch.mapred.output_formats import FileOutputCommitter
            conf = JobConf()
            for k, v in jip.conf.items():
                conf.set(k, v)
            if conf.get("mapred.output.dir"):
                committer = FileOutputCommitter(conf)
                if jip.state == JobState.SUCCEEDED:
                    committer.commit_job()
                else:
                    committer.abort_job()
        except Exception as e:  # noqa: BLE001 — reported on the job
            jip.error = jip.error or f"job finalization failed: {e}"
            with jip.lock:
                if jip.state == JobState.SUCCEEDED:
                    jip.state = JobState.FAILED
        try:
            self.history.job_finished(jip)
            try:
                self.history.write_job_metrics(jip)
            except Exception:  # noqa: BLE001 — the rollup is auxiliary
                _log.exception("writing %s's rollup failed", jip.job_id)
        finally:
            # a job whose history write failed still ends for its clients
            jip.finalized.set()
            if self._running_pipes:
                self._pipe_wake.set()   # a stage may be due now

    # ------------------------------------------------------------ heartbeat

    def heartbeat(self, status: dict, initial_contact: bool,
                  ask_for_new_task: bool, response_id: int) -> dict:
        events: "list[tuple[str, str, dict]]" = []
        finished: "list[JobInProgress]" = []
        try:
            return self._heartbeat(status, initial_contact,
                                   ask_for_new_task, response_id, events,
                                   finished)
        finally:
            # file I/O after the locks: the beat's task events first, so
            # that each job's log keeps its order, then the commits
            for job_id, event, fields in events:
                try:
                    self.history.task_event(job_id, event, **fields)
                except Exception:  # noqa: BLE001 — history is best effort
                    _log.exception("history event %s lost", event)
            for jip in finished:
                self._finalize_job(jip)

    def _heartbeat(self, status: dict, initial_contact: bool,
                   ask_for_new_task: bool, response_id: int,
                   events: "list[tuple[str, str, dict]]",
                   finished: "list[JobInProgress]") -> dict:
        name = status["tracker_name"]
        adopted = False
        with self.lock:
            info = self.trackers.get(name)
            old = None
            if info is not None and initial_contact:
                # a runner that restarted under its old name: what the old
                # incarnation ran is lost
                old = info
                info = self.trackers[name] = _TrackerInfo(status)
                self._last_response.pop(name, None)
            elif info is None:
                # a new runner; one whose beat is not its first is
                # rejoining (this master restarted, or expired it): its
                # running work is adopted below, never reset
                adopted = not initial_contact
                info = self.trackers[name] = _TrackerInfo(status)
                self._last_response.pop(name, None)
            else:
                info.status = status
                info.seen_mono = time.monotonic()
        if old is not None:
            self._count("trackers_restarted")
            self._requeue_tracker_work(old)
        with info.lock:
            if self.trackers.get(name) is not info:
                # expired meanwhile: fold nothing onto the dropped entry;
                # the next beat registers the runner again
                return {"response_id": response_id, "actions": []}
            adopt_kills = self._fold_statuses(info, status, name, adopted,
                                              events, finished)
            # the reduces' fetch-failure reports, folded before the replay
            # check as the statuses are: a runner drops them only once a
            # response arrived, and a report counted twice counts once
            for ff in status.get("fetch_failures") or []:
                self._fetch_failure(ff, events, finished)
            last = self._last_response.get(name)
            if last is not None and last[0] != response_id \
                    and not initial_contact:
                # our last response was lost: replay it, assign nothing
                return {"response_id": last[0], "actions": last[1]}
            actions: "list[dict]" = []
            if adopted:
                # the attempts no job took are killed one by one, and the
                # runner learns each recovered job's new id
                actions += [{"type": "kill_task", "attempt_id": aid}
                            for aid in adopt_kills]
                actions += [{"type": "recover_job", "old": o, "new": n}
                            for o, n in self._recovered.items()]
                # their outputs there are cleaned once the new job ends
                info.jobs.update(self._recovered)
            running_jobs = set()
            for aid in sorted(info.running):
                job_id = str(TaskAttemptID.parse(aid).task.job)
                running_jobs.add(job_id)
                jip = self._resolve_job(job_id)
                if jip is not None and (jip.state in JobState.TERMINAL
                                        or jip.kill_marked(aid)):
                    actions.append({"type": "kill_task", "attempt_id": aid})
            for job_id in sorted(info.jobs - running_jobs):
                # a finished job's files go once none of its attempts runs
                # there (a killed attempt is still writing until it ends)
                jip = self._resolve_job(job_id)
                if jip is not None and jip.finalized.is_set():
                    info.jobs.discard(job_id)
                    actions.append({"type": "cleanup_job",
                                    "job_id": job_id})
            if (ask_for_new_task and status.get("healthy", True)
                    and not info.blacklisted):
                with self.sched_lock:
                    assigned = self.scheduler.assign_tasks(status)
                for task in assigned:
                    job_id = str(task.attempt_id.task.job)
                    self._count("reduces_launched" if not task.is_map
                                else "maps_launched_tpu" if task.run_on_tpu
                                else "maps_launched_cpu")
                    info.running.add(str(task.attempt_id))
                    info.jobs.add(job_id)
                    actions.append({"type": "launch", "job_id": job_id,
                                    "task": task.to_dict()})
                    events.append((job_id, "TASK_STARTED", dict(
                        attempt_id=str(task.attempt_id),
                        is_map=task.is_map, run_on_tpu=task.run_on_tpu,
                        tpu_device_id=task.tpu_device_id, tracker=name)))
            response_id += 1
            self._last_response[name] = (response_id, actions)
            if self._running_pipes:
                # stage submission never runs on a heartbeat's thread:
                # the pipeline thread picks the folds up
                self._pipe_wake.set()
            return {"response_id": response_id, "actions": actions}

    def _fold_statuses(self, info: _TrackerInfo, status: dict, name: str,
                       adopted: bool,
                       events: "list[tuple[str, str, dict]]",
                       finished: "list[JobInProgress]") -> "list[str]":
        """Fold one beat's attempt statuses into their jobs, even on a
        replayed beat: the runner drops a terminal status once a response
        arrived, so a retry may carry the only copy. On a rejoining
        runner's beat a running attempt is adopted first; returns the
        attempts no job took, to be killed."""
        statuses = status.get("task_statuses") or []
        info.running = {sd["attempt_id"] for sd in statuses
                        if sd.get("state") == TaskState.RUNNING}
        addr = info.shuffle_addr()
        adopt_kills: "list[str]" = []
        adopted_n = 0
        for sd in statuses:
            ts = TaskStatus.from_dict(sd)
            aid = str(ts.attempt_id)
            job_id = str(ts.attempt_id.task.job)
            jip = self._resolve_job(job_id)
            if jip is None:
                if adopted and ts.state not in TaskState.TERMINAL:
                    # its job died with the old master
                    adopt_kills.append(aid)
                    info.running.discard(aid)
                continue
            if adopted:
                info.jobs.add(job_id)
            with jip.lock:
                if adopted and ts.state not in TaskState.TERMINAL:
                    if not jip.adopt_running_attempt(ts):
                        adopt_kills.append(aid)
                        info.running.discard(aid)
                        continue
                    adopted_n += 1
                before = jip.state
                tip = jip.tip_of_attempt(aid)
                prev = tip.attempts.get(aid) if tip is not None else None
                reaped = (ts.state == TaskState.FAILED
                          and ts.failure_class == FailureClass.TIMEOUT
                          and (prev is None
                               or prev.state not in TaskState.TERMINAL))
                jip.update_task_status(ts, addr)
                if reaped:   # once an attempt, however often replayed
                    jip.counters.incr(JobCounter.GROUP,
                                      JobCounter.TASKS_REAPED_TIMEOUT)
                if ts.state in TaskState.TERMINAL \
                        and aid not in jip.history_logged:
                    # a replayed beat carries a terminal status again: one
                    # event an attempt
                    jip.history_logged.add(aid)
                    events.append((str(jip.job_id), {
                        TaskState.SUCCEEDED: "TASK_FINISHED",
                        TaskState.KILLED: "TASK_KILLED"}.get(
                            ts.state, "TASK_FAILED"), dict(
                        attempt_id=aid, is_map=ts.is_map,
                        run_on_tpu=ts.run_on_tpu,
                        tpu_device_id=ts.tpu_device_id,
                        runtime=ts.runtime, tracker=name,
                        # where a map's output (or a streaming stage's
                        # reduce copy) is served: recovery feeds it again
                        shuffle_addr=(addr if (ts.is_map
                                               or jip.stream_handoff)
                                      and ts.state == TaskState.SUCCEEDED
                                      else ""),
                        counters=ts.counters or {})))
                    if ts.state == TaskState.FAILED \
                            and info.charge_fault(self.blacklist_faults):
                        _log.warning("runner %s blacklisted", name)
                done = (before == JobState.RUNNING
                        and jip.state in JobState.TERMINAL)
            if reaped:
                self._count("tasks_reaped_timeout")
            if jip.has_accel_events():
                self._drain_accel_events(jip, name, events)
            if ts.state in (TaskState.FAILED, TaskState.KILLED):
                # a dead attempt must not keep its commit grant
                self._revoke_commit(str(ts.attempt_id.task), aid)
            if done:
                finished.append(jip)
        if adopted:
            self._count("trackers_adopted")
            if adopted_n:
                self._count("attempts_adopted", adopted_n)
        return adopt_kills

    def _drain_accel_events(self, jip: JobInProgress, tracker: str,
                            events: "list[tuple[str, str, dict]]") -> None:
        """The job's demotion and quarantine decisions, counted and
        journaled."""
        for ev in jip.drain_accel_events():
            kind = ev.pop("kind")
            ev["tracker"] = tracker
            if kind == "tip_demoted":
                self._count("tpu_demotions")
                events.append((str(jip.job_id), "TIP_TPU_DEMOTED", ev))
            else:
                self._count("jobs_tpu_quarantined")
                events.append((str(jip.job_id), "JOB_TPU_QUARANTINED", ev))

    def _fetch_failure(self, ff: dict, events: "list[tuple[str, str, dict]]",
                       finished: "list[JobInProgress]") -> None:
        """One reduce's report that a map attempt's output cannot be
        fetched (``:3056-3108``): the job counts it; where it withdraws
        the output, the burned attempt's commit grant is revoked, a fault
        is charged to the runner that served the output, and the loss is
        journaled."""
        map_attempt = str(ff.get("map_attempt", ""))
        try:
            task_id = TaskAttemptID.parse(map_attempt).task
        except (ValueError, IndexError):
            return
        jip = self._resolve_job(str(task_id.job))
        if jip is None:
            return
        before = jip.state
        res = jip.fetch_failure_notification(
            map_attempt, str(ff.get("reduce_attempt", "")))
        if res is None:
            return
        self._count("fetch_failures_reported")
        if res["withdrawn"]:
            self._revoke_commit(str(task_id), map_attempt)
            if res["reexecuted"]:
                self._count("maps_reexecuted_fetch_failure")
            addr = res.get("shuffle_addr", "")
            server = self._tracker_by_shuffle_addr(addr)
            if server is not None \
                    and server.charge_fault(self.blacklist_faults):
                _log.warning("runner at %s blacklisted", addr)
            events.append((str(jip.job_id), "MAP_OUTPUT_LOST", dict(
                attempt_id=map_attempt, shuffle_addr=addr,
                reports=res.get("reports", 0),
                reexecuted=res["reexecuted"])))
        if before == JobState.RUNNING and jip.state in JobState.TERMINAL:
            finished.append(jip)

    def _tracker_by_shuffle_addr(self, addr: str) -> "_TrackerInfo | None":
        if not addr:
            return None
        with self.lock:
            for info in self.trackers.values():
                if info.shuffle_addr() == addr:
                    return info
        return None

    # ------------------------------------------------------------ expiry

    def _requeue_tracker_work(self, info: _TrackerInfo) -> None:
        """A lost runner's running attempts, and the finished maps whose
        outputs it served, go back to pending; each withdrawn output is
        journaled, so that a restart does not adopt it."""
        with info.lock:
            attempts = list(info.running)
        addr = info.shuffle_addr()
        with self.lock:
            jobs = list(self.jobs.values())
        for jip in jobs:
            with jip.lock:
                served = [e["attempt_id"] for e in jip.completion_events
                          if e["shuffle_addr"] == addr
                          and e.get("status") != "OBSOLETE"]
            for aid in jip.requeue_lost_attempts(attempts + served):
                self.history.task_event(
                    str(jip.job_id), "MAP_OUTPUT_LOST", attempt_id=aid,
                    shuffle_addr=addr, reason="tracker_lost")
            # its handoff copies die with it: readers fall back to the
            # committed part files
            lost = jip.withdraw_handoff_at(addr)
            if lost:
                self.history.task_event(
                    str(jip.job_id), "HANDOFF_OUTPUT_LOST",
                    shuffle_addr=addr, partitions=lost,
                    reason="tracker_lost")
        for aid in attempts:
            self._revoke_commit(str(TaskAttemptID.parse(aid).task), aid)

    def _expire_loop(self) -> None:
        while not self._stop.wait(min(1.0, self.expiry_s / 3)):
            now = time.monotonic()
            with self.lock:
                lost = [self.trackers.pop(n)
                        for n, t in list(self.trackers.items())
                        if now - t.seen_mono > self.expiry_s]
                for info in lost:
                    self._last_response.pop(info.status["tracker_name"],
                                            None)
            for info in lost:
                self._requeue_tracker_work(info)

    # ------------------------------------------------------------ pipelines

    def submit_pipeline(self, graph_dict: dict) -> str:
        """Admit a validated graph whole and submit its source stages;
        every later stage is submitted here too, so a chain costs its
        client one call."""
        graph = JobGraph.from_dict(dict(graph_dict or {}))
        graph.validate()   # again: the client's check is not trusted
        # a conf hook runs in this process, so only the operator's
        # prefixes may name one
        allowed = [p.strip() for p in str(
            self.conf.get("tpumr.pipeline.conf.hooks.allowed")
            or HOOKS_ALLOWED_DEFAULT).split(",") if p.strip()]
        for nid, n in graph.nodes.items():
            hook = n.get("conf_hook")
            if hook and not any(str(hook).startswith(p) for p in allowed):
                raise PermissionError(
                    f"node {nid!r}: conf_hook {hook!r} is not under an "
                    f"allowed prefix ({', '.join(allowed)}); hooks run in "
                    f"the master: extend tpumr.pipeline.conf.hooks.allowed "
                    f"to admit it")
        user = str(graph.conf.get("user.name", "") or "")
        with self._pipe_lock:
            self._next_pipe += 1
            pid = f"pipe_{self.cluster_id}_{self._next_pipe:04d}"
            pip = self.pipelines[pid] = PipelineInProgress(pid, graph,
                                                           user=user)
            self._running_pipes.add(pid)
        # the whole graph into the journal before any stage is submitted
        self.history.task_event(pid, "PIPELINE_SUBMITTED", pipeline_id=pid,
                                user=user, graph=graph.to_dict())
        self._advance_pipeline(pip)
        return pid

    def _pipeline(self, pipeline_id: str) -> PipelineInProgress:
        pip = self.pipelines.get(pipeline_id)
        if pip is None:
            raise KeyError(f"unknown pipeline {pipeline_id}")
        return pip

    def get_pipeline_status(self, pipeline_id: str) -> dict:
        pip = self._pipeline(pipeline_id)
        with self._pipe_lock:
            return pip.status_dict()

    def list_pipelines(self) -> "list[dict]":
        with self._pipe_lock:
            return [self.pipelines[pid].status_dict()
                    for pid in sorted(self.pipelines)]

    def kill_pipeline(self, pipeline_id: str) -> bool:
        """Kill the pipeline and its running stage jobs; False when it had
        already ended."""
        pip = self._pipeline(pipeline_id)
        with self._pipe_lock:
            was_terminal = pip.state in PipelineState.TERMINAL
            victims = pip.kill()
        self._kill_jobs(victims)
        self._finish_pipeline(pip)
        return not was_terminal

    def get_handoff_completion_events(self, job_id: str,
                                      from_index: int = 0,
                                      max_events: int = 10_000) -> list:
        """A streaming stage's committed-partition announcements, read by
        cursor like the map-completion events."""
        events, _pending = self._job(job_id).handoff_events.read(
            int(from_index), int(max_events))
        return [dict(e) for e in events]

    def handoff_purgeable(self, job_id: str) -> bool:
        """May a runner drop its handoff copies of ``job_id``? Only once
        the job ended and its pipeline, if any, ended too: a finished stage
        serves its pipeline's later stages. An unknown job is purgeable."""
        jip = self._resolve_job(job_id)
        if jip is not None:
            if jip.state not in JobState.TERMINAL:
                return False
            pid = str(jip.conf.get("tpumr.pipeline.id") or "")
        else:
            st = self.history.retired_job_status(job_id)
            if st is None:
                return True
            pid = str((st.get("_acl_conf") or {})
                      .get("tpumr.pipeline.id", "") or "")
        pip = self.pipelines.get(pid)
        return pip is None or pip.state in PipelineState.TERMINAL

    def _kill_jobs(self, job_ids: "list[str]") -> None:
        for jid in job_ids:
            jip = self.jobs.get(jid)
            if jip is not None and jip.kill():
                self._finalize_job(jip)

    def _pipeline_loop(self) -> None:
        """The one thread that advances pipelines, so that a stage's
        submission (conf hooks, split listing) never holds up a
        heartbeat."""
        while not self._stop.is_set():
            self._pipe_wake.wait(PIPELINE_POLL_S)
            self._pipe_wake.clear()
            if self._stop.is_set():
                return
            with self._pipe_lock:
                running = [self.pipelines[pid]
                           for pid in sorted(self._running_pipes)]
            for pip in running:
                if pip.state != PipelineState.RUNNING:
                    continue
                try:
                    self._advance_pipeline(pip)
                except Exception as e:  # noqa: BLE001 — the thread must
                    # go on for the other pipelines; this one fails with it
                    _log.exception("advancing %s failed", pip.pipeline_id)
                    with self._pipe_lock:
                        pip.fail(f"advance failed: {type(e).__name__}: {e}")
                    self._finish_pipeline(pip)

    def _advance_pipeline(self, pip: PipelineInProgress) -> None:
        # bounded: each pass submits stages or stops; a loop node moves
        # one round a pass
        for _ in range(len(pip.nodes) * 4 + 8):
            with self._pipe_lock:
                plans, unresolved = pip.plan_locked(self)
            if not plans and not unresolved:
                break
            for nid, rnd in plans:
                self._submit_stage(pip, nid, rnd)
            if unresolved:
                # stage jobs only history remembers: read outside the lock
                verdicts = [(nid, pip._retired_state(self, jid))
                            for nid, jid in unresolved]
                with self._pipe_lock:
                    for nid, st in verdicts:
                        pip.apply_retired(nid, st)
                if not plans and all(st == JobState.RUNNING
                                     for _, st in verdicts):
                    break   # nothing to do yet
        if pip.state in PipelineState.TERMINAL:
            self._finish_pipeline(pip)

    def _finish_pipeline(self, pip: PipelineInProgress) -> None:
        """Once: a failed pipeline kills its stages still running, since
        half a diamond must not hold slots for a join that cannot run."""
        with self._pipe_lock:
            if pip.finished_recorded:
                return
            pip.finished_recorded = True
            self._running_pipes.discard(pip.pipeline_id)
            victims = (pip.settle_running("killed with pipeline")
                       if pip.state != PipelineState.SUCCEEDED else [])
            nodes = {nid: n.state for nid, n in pip.nodes.items()}
        self._kill_jobs(victims)
        self.history.task_event(
            pip.pipeline_id, "PIPELINE_FINISHED", state=pip.state,
            error=pip.error,
            wall_time=(pip.finish_time or time.time()) - pip.start_time,
            nodes=nodes)

    def _submit_stage(self, pip: PipelineInProgress, nid: str,
                      rnd: int) -> None:
        """Build and submit one stage job, outside the pipeline lock; the
        node is ``SUBMITTING``, so no other pass submits it. A stage that
        cannot be submitted fails the pipeline."""
        node = pip.nodes[nid]
        graph = pip.graph
        try:
            conf = node.round_conf(graph.conf, rnd)
            if pip.user:
                conf.setdefault("user.name", pip.user)
            conf["tpumr.pipeline.id"] = pip.pipeline_id
            conf["tpumr.pipeline.node"] = nid
            conf["tpumr.pipeline.round"] = rnd
            conf.setdefault("mapred.job.name",
                            f"{graph.name or pip.pipeline_id}:{nid}"
                            + (f"@r{rnd}" if node.is_loop else ""))
            if any(e["stream"] for e in graph.downstreams(nid)):
                conf["tpumr.pipeline.stream.handoff"] = True
            ins = graph.upstreams(nid)
            ups = {e["src"]: pip.nodes[e["src"]] for e in ins}
            ups_info = {src: {"job_id": up.job_id,
                              "output_dir": up.output_dir,
                              "num_reduces": up.num_reduces}
                        for src, up in ups.items()}
            splits = None
            if ins and all(e["stream"] for e in ins):
                # one map per upstream reduce partition, fetched over the
                # shuffle wire: the splits are built here, with no listing
                conf["mapred.input.format.class"] = \
                    "tpumr_torch.pipeline.handoff.PipelineHandoffInputFormat"
                conf["tpumr.pipeline.handoff.upstream"] = json.dumps(
                    sorted(i["job_id"] for i in ups_info.values()))
                splits = []
                for src in sorted(ups):
                    up = ups[src]
                    splits += [s.to_dict() for s in build_handoff_splits(
                        up.job_id, up.num_reduces, up.output_dir,
                        self._handoff_serving(up.job_id))]
            elif ins and not str(conf.get("mapred.input.dir") or ""):
                conf["mapred.input.dir"] = ",".join(
                    ups_info[src]["output_dir"] for src in sorted(ups))
            hook = node.spec.get("conf_hook")
            if hook:
                mod_name, _, attr = str(hook).rpartition(".")
                getattr(importlib.import_module(mod_name), attr)(conf,
                                                                 ups_info)
            if splits is None:
                # the client's submission step, the one helper both use
                from tpumr_torch.mapred.job_client import build_submission
                jc = JobConf()
                for k, v in conf.items():
                    jc.set(k, v)
                conf, splits = build_submission(jc)
            job_id = self._submit_job(conf, splits, pip)
            jip = self.jobs[job_id]
            out_dir = str(conf.get("mapred.output.dir") or "")
            with self._pipe_lock:
                accepted = pip.record_submitted(nid, rnd, job_id, out_dir,
                                                jip.num_reduces)
            if not accepted:
                # the pipeline ended while this submission was in flight
                self._kill_jobs([job_id])
            self.history.task_event(
                pip.pipeline_id, "PIPELINE_STAGE_SUBMITTED", node=nid,
                round=rnd, stage_job_id=job_id, output_dir=out_dir,
                num_reduces=jip.num_reduces)
        except Exception as e:  # noqa: BLE001 — the pipeline fails with it
            with self._pipe_lock:
                pip.record_submit_failed(nid, f"{type(e).__name__}: {e}")
            self.history.task_event(
                pip.pipeline_id, "PIPELINE_STAGE_SUBMIT_FAILED", node=nid,
                round=rnd, error=f"{type(e).__name__}: {e}")

    def _handoff_serving(self, job_id: str) -> "dict[int, str]":
        """partition -> serving address of an upstream stage's committed
        handoff copies: the locality hints of the downstream splits."""
        jip = self._resolve_job(job_id)
        if jip is None:
            return {}
        return {e["map_index"]: e["shuffle_addr"]
                for e in jip.handoff_events
                if e.get("status") == "SUCCEEDED"}
