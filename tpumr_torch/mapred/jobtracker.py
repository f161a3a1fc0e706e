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

RPC methods: ``submit_job(conf_dict, splits)`` (``:1326``),
``heartbeat(status, initial_contact, ask_for_new_task, response_id)``,
``get_job_status`` (``:1636``), ``get_counters``, ``get_task_reports``,
``get_map_completion_events`` (``:1893``), ``get_job_conf``,
``can_commit`` (``:2373``), ``kill_job`` and ``get_protocol_version``. The
master is the scheduler's ``TaskTrackerManager`` (``running_jobs``,
``num_trackers``, ``total_slots``).

Left out (``ROADMAP.md``): job history, tracing and metrics, the sharded
tracker registry and lock ranks, ACLs, queues and tokens, pipelines, the
HTTP pages, restart recovery and tracker adoption, the heartbeat delta
encoding, blacklisting, fetch-failure re-execution and host include and
exclude lists.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from tpumr_torch.ipc.rpc import RpcServer
from tpumr_torch.mapred.ids import JobID, TaskAttemptID
from tpumr_torch.mapred.job_in_progress import JobInProgress, JobState
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.scheduler import HybridQueueScheduler
from tpumr_torch.mapred.task import TaskState, TaskStatus
from tpumr_torch.utils.reflection import new_instance

PROTOCOL_VERSION = 29
#: seconds ``stop`` waits for the expiry thread
JOIN_TIMEOUT_S = 5.0


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
        self._server = RpcServer(self, host, port)
        self._stop = threading.Event()
        self._expire_thread = threading.Thread(
            target=self._expire_loop, name="jobmaster-expiry", daemon=True)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "JobMaster":
        self._server.start()
        self._expire_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.stop()
        if self._expire_thread.is_alive():
            self._expire_thread.join(JOIN_TIMEOUT_S)

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
        with self.lock:
            self._next_job += 1
            job_id = JobID(self.cluster_id, self._next_job)
        jip = JobInProgress(job_id, conf_dict, splits)
        with self.lock:
            self.jobs[str(job_id)] = jip
        return str(job_id)

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
            with jip.lock:
                before = jip.state
                jip.update_task_status(ts, addr)
                done = (before == JobState.RUNNING
                        and jip.state in JobState.TERMINAL)
            if ts.state in (TaskState.FAILED, TaskState.KILLED):
                # a dead attempt must not keep its commit grant
                self._revoke_commit(str(ts.attempt_id.task),
                                    str(ts.attempt_id))
            if done:
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
