"""Job history: one JSON-lines event log per job, the master's memory
across a restart.

Counterpart of ``tpumr/mapred/history.py``, whole but for the imports. Each
job's events go to ``<tpumr.history.dir>/<job id>.jsonl`` (a pipeline's to
``<pipeline id>.jsonl``), one self-describing JSON object a line, stamped
``ts`` when enqueued. Event names and fields are the JAX package's, so a
history file written by one package reads the same in the other and yields
the same recovered state.

- :class:`JobHistory` writes through a bounded queue drained by one daemon
  thread (``tpumr.history.async``, default on; ``tpumr.history.queue.max``,
  default 10,000, past which events are dropped and counted in
  ``writes_dropped``); :meth:`JobHistory.flush` waits for the queue to
  drain and :meth:`JobHistory.stop` retires the writer, after which a late
  event is written at once;
- ``job_submitted`` (the whole conf and the splits, so that a restarted
  master can resubmit the job), ``job_recovered``, ``job_finished`` and
  ``task_event``;
- the readers of a restart: :meth:`JobHistory.incomplete_jobs` (with the
  runtime priority changes replayed into the conf),
  :meth:`JobHistory.incomplete_pipelines`,
  :meth:`JobHistory.recovered_attempt_state` (the last successful attempt
  of each task, an output withdrawn by ``MAP_OUTPUT_LOST`` erased) and
  :meth:`JobHistory.retired_job_status` (a finished job's status served
  from its log, or the id it was recovered as);
- the per-job stats rollup ``metrics-<job id>.json``
  (:meth:`JobHistory.write_job_metrics`, :func:`job_metrics_rollup`, exact
  nearest-rank percentiles);
- :func:`job_summary`, one job's events collapsed into the row that
  ``job -history`` prints (``tpumr/mapred/history_server.py:18``; the rest
  of the history server waits for the port's HTTP server).
"""

from __future__ import annotations

import glob
import json
import math
import os
import threading
import time
from typing import Any, Sequence

from tpumr_torch.mapred.ids import TaskAttemptID


def _json_safe(v: Any) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


class JobHistory:
    """The event-log writer and its readers. Without ``tpumr.history.dir``
    every write is a no-op and every reader finds nothing."""

    def __init__(self, conf: Any) -> None:
        self.dir = conf.get("tpumr.history.dir") if conf else None
        self._lock = threading.Lock()
        self._async = bool(conf.get_boolean("tpumr.history.async", True)
                           if conf else True)
        self._queue_max = int(conf.get_int("tpumr.history.queue.max",
                                           10_000) if conf else 10_000)
        self._cv = threading.Condition()
        self._queue: "list[tuple[str, dict]]" = []
        self._writing = False     # a drained batch is being written
        self._stopped = False
        self._writer: "threading.Thread | None" = None
        self.writes_dropped = 0

    # ------------------------------------------------------ write path

    def _write(self, job_id: str, event: dict) -> None:
        if not self.dir:
            return
        event["ts"] = time.time()   # the event's time, not the write's
        if not self._async:
            self._write_now([(job_id, event)])
            return
        with self._cv:
            if not self._stopped:
                if len(self._queue) >= self._queue_max:
                    self.writes_dropped += 1
                    return
                self._queue.append((job_id, event))
                if self._writer is None:
                    self._writer = threading.Thread(
                        target=self._drain, name="history-writer",
                        daemon=True)
                    self._writer.start()
                self._cv.notify_all()
                return
        # after stop (a finalisation racing the shutdown): write at once
        self._write_now([(job_id, event)])

    def _write_now(self, batch: "list[tuple[str, dict]]") -> None:
        """Append a batch, one ``open`` per job file, each file's events
        in their enqueue order."""
        by_job: "dict[str, list[str]]" = {}
        for job_id, event in batch:
            by_job.setdefault(job_id, []).append(json.dumps(event) + "\n")
        os.makedirs(self.dir, exist_ok=True)
        with self._lock:
            for job_id, lines in by_job.items():
                with open(os.path.join(self.dir, f"{job_id}.jsonl"),
                          "a") as f:
                    f.write("".join(lines))

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait(0.5)
                batch, self._queue = self._queue, []
                stopped = self._stopped
                self._writing = bool(batch)
            if batch:
                try:
                    self._write_now(batch)
                except (OSError, TypeError, ValueError):
                    # a full disk, or a value JSON cannot hold: counted,
                    # and the writer goes on
                    self.writes_dropped += len(batch)
                with self._cv:
                    self._writing = False
                    self._cv.notify_all()
            if stopped and not batch:
                return

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Wait until every enqueued event is on disk; True when the queue
        drained within ``timeout_s``."""
        if not self._async or not self.dir:
            return True
        deadline = time.monotonic() + timeout_s
        with self._cv:
            self._cv.notify_all()
            while self._queue or self._writing:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(0.05, left))
        return True

    def stop(self, timeout_s: float = 10.0) -> None:
        """Flush and retire the writer thread: the log is whole on disk
        when this returns, for a restart that replays it at once."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
            writer = self._writer
        if writer is not None:
            writer.join(timeout=timeout_s)

    def job_submitted(self, jip: Any) -> None:
        self._write(str(jip.job_id), {
            "event": "JOB_SUBMITTED",
            "job_id": str(jip.job_id),
            "job_name": jip.conf.get("mapred.job.name", ""),
            "num_maps": jip.num_maps,
            "num_reduces": jip.num_reduces,
            "kernel": jip.conf.get("tpumr.map.kernel"),
            "priority": jip.priority,
            # the whole submission, for a restarted master to resubmit
            "conf": {k: v for k, v in jip.conf.items() if _json_safe(v)},
            # keys that cannot be written (class objects): recovery
            # refuses such a job rather than resubmit it broken
            "conf_dropped": sorted(k for k, v in jip.conf.items()
                                   if not _json_safe(v)),
            "splits": [t.split for t in jip.maps],
        })

    def job_recovered(self, old_job_id: str, new_job_id: str) -> None:
        """The interrupted job was resubmitted as ``new_job_id``, so that
        a second restart does not replay it again."""
        self._write(old_job_id, {"event": "JOB_RECOVERED",
                                 "job_id": old_job_id,
                                 "new_job_id": new_job_id})

    def incomplete_jobs(self) -> "list[dict]":
        """The ``JOB_SUBMITTED`` events of jobs with no terminal or
        recovered marker: a restart's work list. A later
        ``JOB_PRIORITY_CHANGED`` is replayed into the conf."""
        if not self.dir:
            return []
        self.flush()
        out = []
        for path in sorted(glob.glob(os.path.join(self.dir, "*.jsonl"))):
            submitted = None
            finished = False
            priority = None
            for ev in self.read(path):
                kind = ev.get("event")
                if kind == "JOB_SUBMITTED":
                    submitted = ev
                elif kind in ("JOB_FINISHED", "JOB_RECOVERED",
                              "JOB_RECOVERY_FAILED"):
                    finished = True
                elif kind == "JOB_PRIORITY_CHANGED":
                    priority = ev.get("priority")
            if submitted is not None and not finished \
                    and submitted.get("conf") is not None:
                if priority:
                    submitted["conf"]["mapred.job.priority"] = priority
                out.append(submitted)
        return out

    def incomplete_pipelines(self) -> "list[dict]":
        """Each pipeline with no terminal marker: its graph, its user and
        its stage submissions in order. ``PIPELINE_RECOVERED`` does not end
        a log: the pipeline keeps its id across restarts."""
        if not self.dir:
            return []
        self.flush()
        out = []
        for path in sorted(glob.glob(os.path.join(self.dir,
                                                  "pipe_*.jsonl"))):
            submitted = None
            finished = False
            stages: "list[dict]" = []
            for ev in self.read(path):
                kind = ev.get("event")
                if kind == "PIPELINE_SUBMITTED":
                    submitted = ev
                elif kind in ("PIPELINE_FINISHED",
                              "PIPELINE_RECOVERY_FAILED"):
                    finished = True
                elif kind == "PIPELINE_STAGE_SUBMITTED":
                    stages.append(ev)
            if submitted is not None and not finished \
                    and submitted.get("graph"):
                out.append({"pipeline_id": submitted["pipeline_id"],
                            "graph": submitted["graph"],
                            "user": submitted.get("user", ""),
                            "stages": stages})
        return out

    def recovered_attempt_state(self, job_id: str) -> dict:
        """An interrupted job's finished attempts, replayed from its log:
        the last successful attempt of each task with its attempt id,
        tracker, serving address, backend, runtime and counters. A
        ``MAP_OUTPUT_LOST`` erases the output it names. Returns
        ``{"maps": {partition: record}, "reduces": {partition: record}}``.
        """
        maps: "dict[int, dict]" = {}
        reduces: "dict[int, dict]" = {}
        if not self.dir:
            return {"maps": maps, "reduces": reduces}
        self.flush()
        path = os.path.join(self.dir, f"{job_id}.jsonl")
        if not os.path.exists(path):
            return {"maps": maps, "reduces": reduces}
        for ev in self.read(path):
            kind = ev.get("event")
            aid = str(ev.get("attempt_id", "") or "")
            if not aid:
                continue
            try:
                attempt = TaskAttemptID.parse(aid)
            except (ValueError, IndexError):
                continue
            idx = attempt.task.id
            if kind == "TASK_FINISHED":
                rec = {
                    "attempt_id": aid,
                    "attempt": attempt.attempt,
                    "is_map": bool(attempt.task.is_map),
                    "runtime": float(ev.get("runtime", 0.0) or 0.0),
                    "tracker": ev.get("tracker", ""),
                    "shuffle_addr": ev.get("shuffle_addr", "") or "",
                    "run_on_tpu": bool(ev.get("run_on_tpu", False)),
                    "tpu_device_id": int(ev.get("tpu_device_id", -1)),
                    "counters": ev.get("counters") or {},
                    "ts": float(ev.get("ts", 0.0) or 0.0),
                }
                (maps if attempt.task.is_map else reduces)[idx] = rec
            elif kind == "MAP_OUTPUT_LOST":
                # withdrawn by the old master: a replacement shows as a
                # later TASK_FINISHED, or not at all
                cur = maps.get(idx)
                if cur is not None and cur["attempt_id"] == aid:
                    del maps[idx]
        return {"maps": maps, "reduces": reduces}

    def retired_job_status(self, job_id: str) -> "dict | None":
        """A client-shaped status of a job that only its log remembers;
        for a job an earlier master resubmitted, ``{"job_id",
        "recovered_as"}``. None when the log holds no outcome."""
        if not self.dir:
            return None
        self.flush()
        path = os.path.join(self.dir, f"{job_id}.jsonl")
        if not os.path.exists(path):
            return None
        submitted: "dict | None" = None
        outcome: "dict | None" = None
        for ev in self.read(path):
            kind = ev.get("event")
            if kind == "JOB_SUBMITTED":
                submitted = ev
            elif kind in ("JOB_FINISHED", "JOB_RECOVERED",
                          "JOB_RECOVERY_FAILED"):
                outcome = ev
        if outcome is None:
            return None
        if outcome["event"] == "JOB_RECOVERED":
            return {"job_id": job_id,
                    "recovered_as": outcome.get("new_job_id")}
        #: the submit-time conf (popped before the status goes out)
        acl_conf = (submitted or {}).get("conf") or {}
        n_maps = int((submitted or {}).get("num_maps", 0) or 0)
        n_reduces = int((submitted or {}).get("num_reduces", 0) or 0)
        if outcome["event"] == "JOB_FINISHED":
            state = str(outcome.get("state", "SUCCEEDED"))
            error = str(outcome.get("error", "") or "")
        else:   # JOB_RECOVERY_FAILED
            state = "FAILED"
            error = (f"recovery failed after a master restart: "
                     f"{outcome.get('error', '')}")
        done = state == "SUCCEEDED"
        return {
            "job_id": job_id, "state": state, "priority": "NORMAL",
            "map_progress": 1.0 if done else 0.0,
            "reduce_progress": 1.0 if done else 0.0,
            "finished_maps": n_maps if done else 0,
            "finished_tpu_maps": int(
                outcome.get("finished_tpu_maps", 0) or 0),
            "finished_cpu_maps": int(
                outcome.get("finished_cpu_maps", 0) or 0),
            "num_maps": n_maps, "num_reduces": n_reduces,
            "cpu_map_mean_time": float(
                outcome.get("cpu_map_mean_time", 0.0) or 0.0),
            "tpu_map_mean_time": float(
                outcome.get("tpu_map_mean_time", 0.0) or 0.0),
            "acceleration_factor": float(
                outcome.get("acceleration_factor", 0.0) or 0.0),
            "placement_seq": "", "tpu_disabled": False,
            "tpu_demoted_tips": 0,
            "error": error,
            "retired": True,
            "_acl_conf": acl_conf,
        }

    def job_finished(self, jip: Any) -> None:
        self._write(str(jip.job_id), {
            "event": "JOB_FINISHED",
            "job_id": str(jip.job_id),
            "state": jip.state,
            "wall_time": (jip.finish_time or time.time()) - jip.start_time,
            "finished_cpu_maps": jip.finished_cpu_maps,
            "finished_tpu_maps": jip.finished_tpu_maps,
            "cpu_map_mean_time": jip.cpu_map_mean_time(),
            "tpu_map_mean_time": jip.tpu_map_mean_time(),
            "acceleration_factor": jip.acceleration_factor(),
            "placement": jip.placement_timeline(),
            "error": jip.error,
        })

    def task_event(self, job_id: str, event: str, **fields: Any) -> None:
        self._write(job_id, {"event": event, **fields})

    # ------------------------------------------------------ stats rollup

    def metrics_path(self, job_id: str) -> "str | None":
        if not self.dir:
            return None
        return os.path.join(self.dir, f"metrics-{job_id}.json")

    def write_job_metrics(self, jip: Any) -> "str | None":
        """The job's stats rollup, written once at finalisation beside its
        log (replaced whole, so a reader never sees half of it)."""
        path = self.metrics_path(str(jip.job_id))
        if path is None:
            return None
        os.makedirs(self.dir, exist_ok=True)
        rollup = job_metrics_rollup(jip)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                json.dump(rollup, f, indent=2, default=str)
            os.replace(tmp, path)
        return path

    def read_job_metrics(self, job_id: str) -> "dict | None":
        path = self.metrics_path(job_id)
        if path is None or not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def read(path: str) -> "list[dict]":
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


def job_summary(events: "list[dict]") -> dict:
    """One job's events collapsed: submission, the priority it ran at,
    and its end."""
    out: "dict[str, Any]" = {"events": len(events)}
    for ev in events:
        kind = ev.get("event")
        if kind == "JOB_SUBMITTED":
            out.update(job_id=ev.get("job_id"), name=ev.get("job_name"),
                       num_maps=ev.get("num_maps"),
                       num_reduces=ev.get("num_reduces"),
                       kernel=ev.get("kernel"), submitted_ts=ev.get("ts"),
                       priority=ev.get("priority", "NORMAL"))
        elif kind == "JOB_PRIORITY_CHANGED":
            out["priority"] = ev.get("priority", out.get("priority"))
        elif kind == "JOB_FINISHED":
            out.update(state=ev.get("state"),
                       wall_time=ev.get("wall_time"),
                       finished_cpu_maps=ev.get("finished_cpu_maps"),
                       finished_tpu_maps=ev.get("finished_tpu_maps"),
                       acceleration_factor=ev.get("acceleration_factor"),
                       placement=ev.get("placement"),
                       error=ev.get("error"))
    return out


def exact_percentiles(values: "Sequence[float]",
                      qs: "Sequence[float]" = (0.50, 0.95, 0.99)) -> dict:
    """Nearest-rank quantiles of a finished sample, with its count, mean
    and max; {} for an empty one (``tpumr/metrics/histogram.py:298``)."""
    if not values:
        return {}
    s = sorted(float(v) for v in values)
    out = {}
    for q in qs:
        idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
        out[f"p{int(q * 100)}"] = s[idx]
    out["count"] = len(s)
    out["mean"] = sum(s) / len(s)
    out["max"] = s[-1]
    return out


def job_metrics_rollup(jip: Any) -> dict:
    """A terminal job's rollup: counters, exact latency percentiles and
    the accelerator/CPU task-time split, from every successful attempt's
    runtime (not the scheduler's profile sums, which a quarantine
    unwinds)."""
    with jip.lock:
        map_rts = list(jip.map_runtimes)
        reduce_rts = list(jip.reduce_runtimes)
        dropped = jip.runtimes_dropped
        counters = jip.counters.to_dict()
        state = jip.state
        finish = jip.finish_time
    tpu = [r for r, on_tpu in map_rts if on_tpu]
    cpu = [r for r, on_tpu in map_rts if not on_tpu]
    tpu_s, cpu_s = sum(tpu), sum(cpu)
    map_task_s = tpu_s + cpu_s
    observed_accel = ((cpu_s / len(cpu)) / (tpu_s / len(tpu))
                      if tpu and cpu and tpu_s > 0 else 0.0)
    return {
        "job_id": str(jip.job_id),
        "job_name": str(jip.conf.get("mapred.job.name", "") or ""),
        "state": state,
        "wall_time": (finish or time.time()) - jip.start_time,
        "num_maps": len(jip.maps),
        "num_reduces": len(jip.reduces),
        "map_latency": exact_percentiles([r for r, _ in map_rts]),
        "map_latency_tpu": exact_percentiles(tpu),
        "map_latency_cpu": exact_percentiles(cpu),
        "reduce_latency": exact_percentiles(reduce_rts),
        "task_time_split": {
            "tpu_map_s": tpu_s,
            "cpu_map_s": cpu_s,
            "reduce_s": sum(reduce_rts),
            "tpu_fraction_of_map_time":
                tpu_s / map_task_s if map_task_s > 0 else 0.0,
        },
        "acceleration_factor_profiled": jip.acceleration_factor(),
        "acceleration_factor_observed": observed_accel,
        "finished_tpu_maps": len(tpu),
        "finished_cpu_maps": len(cpu),
        "runtime_samples_dropped": dropped,
        "counters": counters,
    }
