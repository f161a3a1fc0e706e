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
``can_commit`` (``:2373``), ``kill_job``, ``list_jobs`` (``:1503``),
``get_active_trackers`` (``:1773``), ``get_metrics`` and
``get_protocol_version``. The master is the scheduler's
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

Left out (``ROADMAP.md``): job history, tracing and the metrics registry
(the port keeps the fault-tolerance counts only), the sharded
tracker registry and lock ranks, ACLs, queues and tokens, the HTTP pages,
restart recovery (of jobs and pipelines) and tracker adoption, the
heartbeat delta encoding, blacklisting (so the fault that a lost output
charges to the runner that served it), the fetch-failure metrics and
history events, and host include and exclude lists.
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
from tpumr_torch.mapred.ids import JobID, TaskAttemptID
from tpumr_torch.mapred.job_in_progress import JobInProgress, JobState
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

    def shuffle_addr(self) -> str:
        st = self.status
        return st.get("shuffle_addr") or \
            f"{st.get('host', '')}:{st.get('shuffle_port', 0)}"


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
        self._next_job = 0
        self.cluster_id = str(int(time.time() * 1000))
        self.expiry_s = conf.get_int("tpumr.tracker.expiry.ms",
                                     10_000) / 1000.0
        self.scheduler = new_instance(
            conf.get_class("mapred.jobtracker.taskScheduler",
                           HybridQueueScheduler), conf)
        self.scheduler.set_manager(self)
        #: pipeline id -> its state; guarded by ``_pipe_lock``
        self.pipelines: "dict[str, PipelineInProgress]" = {}
        #: ids of the pipelines still running: the only ones the pipeline
        #: thread walks, and while there are none it is not woken
        self._running_pipes: "set[str]" = set()
        self._pipe_lock = threading.Lock()
        self._next_pipe = 0
        self._pipe_wake = threading.Event()
        #: the fault-tolerance counts :meth:`get_metrics` serves
        self._metrics = {"tpu_demotions": 0, "jobs_tpu_quarantined": 0,
                         "tasks_reaped_timeout": 0}
        self._server = RpcServer(self, host, port)
        self._stop = threading.Event()
        self._expire_thread = threading.Thread(
            target=self._expire_loop, name="jobmaster-expiry", daemon=True)
        self._pipe_thread = threading.Thread(
            target=self._pipeline_loop, name="jobmaster-pipeline",
            daemon=True)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "JobMaster":
        self._server.start()
        self._expire_thread.start()
        self._pipe_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._pipe_wake.set()
        self._server.stop()
        for t in (self._expire_thread, self._pipe_thread):
            if t.is_alive():
                t.join(JOIN_TIMEOUT_S)

    @property
    def address(self) -> tuple[str, int]:
        return self._server.address

    # ------------------------------------------------------------ manager

    def running_jobs(self) -> "list[JobInProgress]":
        with self.lock:
            return [j for j in self.jobs.values()
                    if j.state == JobState.RUNNING]

    def num_trackers(self) -> int:
        with self.lock:
            return max(1, len(self.trackers))

    def get_active_trackers(self) -> "list[str]":
        """The runners' names; an unhealthy one followed by a tab and
        ``UNHEALTHY: <the health script's report>``."""
        out = []
        with self.lock:
            for name in sorted(self.trackers):
                st = self.trackers[name].status or {}
                if st.get("healthy", True):
                    out.append(name)
                else:
                    reason = st.get("health_report", "") or "unhealthy"
                    out.append(f"{name}\tUNHEALTHY: {reason}")
        return out

    def get_metrics(self) -> dict:
        """Demotions, job quarantines and reaps since the start, and the
        cards quarantined on the runners now."""
        with self.lock:
            out = dict(self._metrics)
            out["tpu_devices_quarantined"] = sum(
                len(t.status.get("quarantined_tpu_devices") or [])
                for t in self.trackers.values())
        return out

    def _count(self, key: str) -> None:
        with self.lock:
            self._metrics[key] += 1

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
        return str(job_id)

    def list_jobs(self) -> "list[str]":
        """Every job id the master knows, in order."""
        with self.lock:
            return sorted(self.jobs)

    def _job(self, job_id: str) -> JobInProgress:
        jip = self.jobs.get(job_id)
        if jip is None:
            raise KeyError(f"unknown job {job_id}")
        return jip

    def get_job_status(self, job_id: str) -> dict:
        jip = self._job(job_id)
        d = jip.status_dict()
        if d["state"] in JobState.TERMINAL and not jip.finalized.is_set():
            # commit or abort still running: the output is not there yet
            d["state"] = JobState.RUNNING
        return d

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

    def can_commit(self, task_id: str, attempt_id: str) -> bool:
        """The first attempt of a task to ask wins the commit; an attempt
        the master already settled is refused."""
        jip = self.jobs.get(str(TaskAttemptID.parse(attempt_id).task.job))
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
        """Commit (or abort) the job's output once, then make its terminal
        state visible."""
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
        finally:
            jip.finalized.set()
            if self._running_pipes:
                self._pipe_wake.set()   # a stage may be due now

    # ------------------------------------------------------------ heartbeat

    def heartbeat(self, status: dict, initial_contact: bool,
                  ask_for_new_task: bool, response_id: int) -> dict:
        finished: "list[JobInProgress]" = []
        try:
            return self._heartbeat(status, initial_contact,
                                   ask_for_new_task, response_id, finished)
        finally:
            # commits are file I/O: after the locks, before the next beat
            for jip in finished:
                self._finalize_job(jip)

    def _heartbeat(self, status: dict, initial_contact: bool,
                   ask_for_new_task: bool, response_id: int,
                   finished: "list[JobInProgress]") -> dict:
        name = status["tracker_name"]
        with self.lock:
            info = self.trackers.get(name)
            old = None
            if info is None or initial_contact:
                # a new runner, or one that restarted under its old name:
                # what the old incarnation ran is lost
                old = info
                info = self.trackers[name] = _TrackerInfo(status)
                self._last_response.pop(name, None)
            else:
                info.status = status
                info.seen_mono = time.monotonic()
        if old is not None:
            self._requeue_tracker_work(old)
        with info.lock:
            self._fold_statuses(info, status, finished)
            # the reduces' fetch-failure reports, folded before the replay
            # check as the statuses are: a runner drops them only once a
            # response arrived, and a report counted twice counts once
            for ff in status.get("fetch_failures") or []:
                self._fetch_failure(ff, finished)
            last = self._last_response.get(name)
            if last is not None and last[0] != response_id \
                    and not initial_contact:
                # our last response was lost: replay it, assign nothing
                return {"response_id": last[0], "actions": last[1]}
            actions: "list[dict]" = []
            running_jobs = set()
            for aid in sorted(info.running):
                job_id = str(TaskAttemptID.parse(aid).task.job)
                running_jobs.add(job_id)
                jip = self.jobs.get(job_id)
                if jip is not None and jip.state in JobState.TERMINAL:
                    actions.append({"type": "kill_task", "attempt_id": aid})
            for job_id in sorted(info.jobs - running_jobs):
                # a finished job's files go once none of its attempts runs
                # there (a killed attempt is still writing until it ends)
                jip = self.jobs.get(job_id)
                if jip is not None and jip.finalized.is_set():
                    info.jobs.discard(job_id)
                    actions.append({"type": "cleanup_job",
                                    "job_id": job_id})
            if ask_for_new_task and status.get("healthy", True):
                with self.sched_lock:
                    assigned = self.scheduler.assign_tasks(status)
                for task in assigned:
                    job_id = str(task.attempt_id.task.job)
                    info.running.add(str(task.attempt_id))
                    info.jobs.add(job_id)
                    actions.append({"type": "launch", "job_id": job_id,
                                    "task": task.to_dict()})
            response_id += 1
            self._last_response[name] = (response_id, actions)
            if self._running_pipes:
                # stage submission never runs on a heartbeat's thread:
                # the pipeline thread picks the folds up
                self._pipe_wake.set()
            return {"response_id": response_id, "actions": actions}

    def _fold_statuses(self, info: _TrackerInfo, status: dict,
                       finished: "list[JobInProgress]") -> None:
        """Fold one beat's attempt statuses into their jobs, even on a
        replayed beat: the runner drops a terminal status once a response
        arrived, so a retry may carry the only copy."""
        statuses = status.get("task_statuses") or []
        info.running = {sd["attempt_id"] for sd in statuses
                        if sd.get("state") == TaskState.RUNNING}
        addr = info.shuffle_addr()
        for sd in statuses:
            ts = TaskStatus.from_dict(sd)
            jip = self.jobs.get(str(ts.attempt_id.task.job))
            if jip is None:
                continue
            aid = str(ts.attempt_id)
            with jip.lock:
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
                done = (before == JobState.RUNNING
                        and jip.state in JobState.TERMINAL)
            if reaped:
                self._count("tasks_reaped_timeout")
            if jip.has_accel_events():
                for ev in jip.drain_accel_events():
                    self._count("tpu_demotions" if ev["kind"] == "tip_demoted"
                                else "jobs_tpu_quarantined")
            if ts.state in (TaskState.FAILED, TaskState.KILLED):
                # a dead attempt must not keep its commit grant
                self._revoke_commit(str(ts.attempt_id.task),
                                    str(ts.attempt_id))
            if done:
                finished.append(jip)

    def _fetch_failure(self, ff: dict,
                       finished: "list[JobInProgress]") -> None:
        """One reduce's report that a map attempt's output cannot be
        fetched (``:3056-3085``): the job counts it, and where it withdraws
        the output the burned attempt's commit grant is revoked, so that
        the re-run can commit."""
        map_attempt = str(ff.get("map_attempt", ""))
        try:
            task_id = TaskAttemptID.parse(map_attempt).task
        except (ValueError, IndexError):
            return
        jip = self.jobs.get(str(task_id.job))
        if jip is None:
            return
        before = jip.state
        res = jip.fetch_failure_notification(
            map_attempt, str(ff.get("reduce_attempt", "")))
        if res is None:
            return
        if res["withdrawn"]:
            self._revoke_commit(str(task_id), map_attempt)
        if before == JobState.RUNNING and jip.state in JobState.TERMINAL:
            finished.append(jip)

    # ------------------------------------------------------------ expiry

    def _requeue_tracker_work(self, info: _TrackerInfo) -> None:
        """A lost runner's running attempts, and the finished maps whose
        outputs it served, go back to pending."""
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
            jip.requeue_lost_attempts(attempts + served)
            # its handoff copies die with it: readers fall back to the
            # committed part files
            jip.withdraw_handoff_at(addr)
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
        with self._pipe_lock:
            self._next_pipe += 1
            pid = f"pipe_{self.cluster_id}_{self._next_pipe:04d}"
            pip = self.pipelines[pid] = PipelineInProgress(pid, graph)
            self._running_pipes.add(pid)
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
        jip = self.jobs.get(job_id)
        if jip is None:
            return True
        if jip.state not in JobState.TERMINAL:
            return False
        pip = self.pipelines.get(str(jip.conf.get("tpumr.pipeline.id")
                                     or ""))
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
                plans = pip.plan_locked(self)
            if not plans:
                break
            for nid, rnd in plans:
                self._submit_stage(pip, nid, rnd)
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
        self._kill_jobs(victims)

    def _submit_stage(self, pip: PipelineInProgress, nid: str,
                      rnd: int) -> None:
        """Build and submit one stage job, outside the pipeline lock; the
        node is ``SUBMITTING``, so no other pass submits it. A stage that
        cannot be submitted fails the pipeline."""
        node = pip.nodes[nid]
        graph = pip.graph
        try:
            conf = node.round_conf(graph.conf, rnd)
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
            with self._pipe_lock:
                accepted = pip.record_submitted(
                    nid, rnd, job_id, str(conf.get("mapred.output.dir")
                                          or ""), jip.num_reduces)
            if not accepted:
                # the pipeline ended while this submission was in flight
                self._kill_jobs([job_id])
        except Exception as e:  # noqa: BLE001 — the pipeline fails with it
            with self._pipe_lock:
                pip.record_submit_failed(nid, f"{type(e).__name__}: {e}")

    def _handoff_serving(self, job_id: str) -> "dict[int, str]":
        """partition -> serving address of an upstream stage's committed
        handoff copies: the locality hints of the downstream splits."""
        jip = self.jobs.get(job_id)
        if jip is None:
            return {}
        return {e["map_index"]: e["shuffle_addr"]
                for e in jip.handoff_events
                if e.get("status") == "SUCCEEDED"}
