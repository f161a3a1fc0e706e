"""Per-job task bookkeeping and per-backend runtime profiling, on the job
master.

Counterpart of ``tpumr/mapred/job_in_progress.py``. The pieces the hybrid
scheduler reads are kept exactly, so that both packages' schedulers see the
same numbers from the same task statuses:

- ``finished_cpu_maps`` / ``finished_tpu_maps`` and the running sums of
  each backend's map runtimes (``status.runtime``, the node runner's
  finish less start stamp), with the optional EWMA of
  ``tpumr.profile.ewma`` (default off), folded in :meth:`_on_success`
  (``:1043-1068`` there); :meth:`cpu_map_mean_time`,
  :meth:`tpu_map_mean_time` and :meth:`acceleration_factor`
  (``cpuMean / tpuMean``, 1.0 until both backends have a finished map;
  ``:479-504``);
- the pending sets and the host-locality cache behind
  :meth:`obtain_new_map_task` (node-local split first, then the lowest
  pending index; ``:659-707``) and :meth:`obtain_new_reduce_task` with
  the reduce slow-start gate (``:872``);
- :meth:`_on_failure`: a FAILED attempt counts toward
  ``mapred.{map,reduce}.max.attempts`` and requeues its task, and the
  job fails at the limit; a KILLED attempt requeues without counting;
- the placement stamps (``run_on_tpu``, ``tpu_device_id``) on each task's
  report at assignment, the placement timeline, :meth:`status_dict` and
  the job's summed counters;
- :class:`CompletionEventFeed`, the append-only map-completion feed that
  reduces poll for map output locations (a withdrawn output marked
  ``OBSOLETE`` in place and announced by a tombstone,
  :meth:`_obsolete_map_output`, ``:1188``), and a second one,
  ``handoff_events``, on which a streaming pipeline stage announces each
  committed reduce partition (``map_index`` holding the partition;
  ``:341-356, 1083-1090``); :meth:`withdraw_handoff_at` tombstones a lost
  runner's announcements (``:1360-1385``);
- :meth:`fetch_failure_notification` (``:1220-1302``), the master's side of
  the lost-output protocol: a running reduce attempt of this job reports a
  map attempt's output unfetchable; reports count once per reduce task,
  and at ``min(mapred.max.fetch.failures.per.map, live reduces)`` of them
  the attempt is failed and burned, its output withdrawn, the finished-map
  books unwound (:meth:`_unwind_finished_map`, ``:1205``), and the map
  goes back to the pending set for any slot; a map that keeps losing its
  output fails the job at ``mapred.map.max.attempts``;
- ``sched_anchor``, the FIFO sort key: the submit time, or the pipeline's
  for a pipeline's stage job (``:357``);
- the accelerator fault tolerance (``:357-380, 450-505, 1113-1185``): an
  accelerator attempt that FAILED classed ``device`` or ``compile`` is one
  of its map's ``tpu_failures``; at ``tpumr.tpu.attempt.retries`` (default
  1) the map is demoted, pinned to the CPU slots (``_cpu_only_maps``,
  ``TPU_DEMOTIONS``), and at ``tpumr.tpu.job.quarantine.tips`` (default 3)
  distinct such maps the job's accelerator pass is quarantined
  (``tpu_disabled``): the accelerator profile sums are unwound so that
  :meth:`acceleration_factor` returns 1.0, and accelerator completions that
  arrive after it count in neither profile. A user, ``oom``, ``timeout``
  or unclassified failure goes back for any slot. The decisions are queued
  for the master (:meth:`drain_accel_events`); ``status_dict`` carries
  ``tpu_disabled`` and ``tpu_demoted_tips``. A map re-executed for lost
  output did not fail on the device either, and goes to any slot.

- speculative attempts (``:544-656, 709-784, 896-948``): when no map is
  pending, a free slot may take a twin of a running map, and of a running
  reduce likewise (:meth:`_obtain_speculative_map`,
  :meth:`_obtain_speculative_reduce`; ``mapred.speculative.execution``,
  default on, ``mapred.reduce.speculative.execution`` defaulting to it,
  ``mapred.speculative.lag.factor`` 1.5, ``mapred.speculative.min.runtime.s``
  10). Targeted (``tpumr.speculative.targeted``, default on): a task is
  twinned once its age passes the floor, its age plus its estimated
  remaining seconds pass the factor times the mean finished runtime, and
  its remaining estimate is within ``tpumr.speculative.critical.fraction``
  (0.75) of the longest (:meth:`critical_path_maps`), at most
  ``tpumr.speculative.cap`` (2) twins in flight; blanket, the age alone
  against ``max(floor, factor * mean)``. The estimate is the progress-rate
  EWMA folded from each RUNNING status on the master's monotonic clock
  (``tpumr.speculative.rate.ewma`` 0.4; :meth:`_fold_progress`,
  :meth:`_tip_remaining_s`, :meth:`longest_remaining_path_s`). One twin a
  task; the first success wins and the others are marked for the kill scan
  (:meth:`kill_marked`); ``status_dict`` carries ``speculative_launched``,
  ``_won``, ``_wasted`` and ``_in_flight``. The brownout hold of the
  reference is left out with the brownout;
- operator kills (``:813-834``): :meth:`request_attempt_kill` marks a
  running attempt, and with ``fail`` its KILLED report is counted FAILED;
- restart recovery (``:1387-1530``): :meth:`recover_attempts` replays an
  interrupted job's finished attempts from its history into this
  resubmitted job (maps with their original attempt ids and serving
  addresses, completion events re-fed; reduces counted done), after which
  attempt ids of the old job count as this job's own
  (``recovered_from``); :meth:`adopt_running_attempt` binds an attempt a
  rejoining runner still runs; ``schedule_hold_until`` holds the job's
  tasks back for the recovery grace; ``history_logged`` names the attempts
  whose outcome is in the log; every successful attempt's runtime is kept
  for the stats rollup (``map_runtimes``, ``reduce_runtimes``).

Left out (``ROADMAP.md``): brownout holds, preemption, the devcache tags
and rack locality.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any

from tpumr_torch.core.counters import Counters, JobCounter
from tpumr_torch.mapred.ids import JobID, TaskAttemptID, TaskID
from tpumr_torch.mapred.task import (FailureClass, Task, TaskPhase,
                                     TaskReport, TaskState, TaskStatus)

#: defaults of the keys read here, the JAX package's (its confkeys registry)
_DEFAULTS = {"mapred.reduce.tasks": 1, "mapred.map.max.attempts": 4,
             "mapred.reduce.max.attempts": 4,
             "mapred.reduce.slowstart.completed.maps": 0.05,
             "mapred.max.fetch.failures.per.map": 3,
             "mapred.job.priority": "NORMAL", "tpumr.profile.ewma": 0.0,
             "mapred.job.map.memory.mb": 0, "mapred.job.reduce.memory.mb": 0,
             "tpumr.tpu.attempt.retries": 1,
             "tpumr.tpu.job.quarantine.tips": 3,
             "mapred.speculative.execution": True,
             "mapred.speculative.lag.factor": 1.5,
             "mapred.speculative.min.runtime.s": 10.0,
             "tpumr.speculative.targeted": True,
             "tpumr.speculative.cap": 2,
             "tpumr.speculative.critical.fraction": 0.75,
             "tpumr.speculative.rate.ewma": 0.4}


def _conf_value(conf: dict, key: str) -> Any:
    v = conf.get(key)
    return _DEFAULTS[key] if v is None else v


def _flag(conf: dict, key: str) -> bool:
    return str(conf.get(key, "")).strip().lower() in ("true", "1", "yes",
                                                     "on")


def _bool(conf: dict, key: str) -> bool:
    """A boolean key with its default, read as the JAX package's
    registry reads it."""
    v = _conf_value(conf, key)
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes", "on")
    return bool(v)


class CompletionEventFeed:
    """Append-only map-completion events. Writers append under the job
    lock; a withdrawn output is marked ``OBSOLETE`` in place and announced
    again as a tombstone, never removed, so an index once served names the
    same event forever and readers slice by cursor without a lock."""

    __slots__ = ("_events",)

    def __init__(self) -> None:
        self._events: "list[dict]" = []

    def append(self, event: dict) -> None:
        self._events.append(event)

    def read(self, from_index: int, max_events: int) -> "tuple[list, int]":
        """Up to ``max_events`` events from ``from_index``, and how many
        remain after them."""
        total = len(self._events)
        frm = max(0, int(from_index))
        if frm > total:
            frm = 0
        events = self._events[frm:frm + max(0, int(max_events))]
        return events, max(0, total - frm - len(events))

    def __iter__(self) -> Any:
        return iter(self._events)


class JobState:
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"
    TERMINAL = {SUCCEEDED, FAILED, KILLED}


#: scheduling order of the priorities (``mapred.job.priority``)
JOB_PRIORITIES = ("VERY_HIGH", "HIGH", "NORMAL", "LOW", "VERY_LOW")


def normalize_priority(value: Any) -> str:
    p = str(value).upper()
    if p not in JOB_PRIORITIES:
        raise ValueError(f"unknown job priority {value!r}; one of "
                         f"{', '.join(JOB_PRIORITIES)}")
    return p


def priority_rank(priority: str) -> int:
    """Sort key: a lower rank schedules first."""
    return JOB_PRIORITIES.index(priority)


@dataclass
class TaskInProgress:
    """One logical task, its attempts and its state."""

    task_id: TaskID
    partition: int
    split: "dict | None" = None
    state: str = "pending"            # pending | running | succeeded | failed
    attempts: "dict[str, TaskStatus]" = field(default_factory=dict)
    next_attempt: int = 0
    failures: int = 0
    #: FAILED accelerator attempts classed device or compile
    tpu_failures: int = 0
    successful_attempt: str = ""
    report: TaskReport = None  # type: ignore[assignment]
    # the progress-rate model, on the master's monotonic clock only
    #: the current incarnation's first dispatch; 0.0 until assigned
    dispatch_mono: float = 0.0
    #: EWMA of progress per second, folded from RUNNING statuses
    rate_ewma: float = 0.0
    #: the best progress seen and when
    last_progress: float = 0.0
    last_progress_mono: float = 0.0

    def __post_init__(self) -> None:
        if self.report is None:
            self.report = TaskReport(self.task_id)

    def new_attempt(self) -> TaskAttemptID:
        a = TaskAttemptID(self.task_id, self.next_attempt)
        self.next_attempt += 1
        return a

    def reset_feedback(self) -> None:
        """A requeue: the next incarnation's age and rate start anew."""
        self.dispatch_mono = 0.0
        self.rate_ewma = 0.0
        self.last_progress = 0.0
        self.last_progress_mono = 0.0

    @property
    def is_map(self) -> bool:
        return self.task_id.is_map

    def running_attempts(self) -> "list[TaskStatus]":
        return [s for s in self.attempts.values()
                if s.state == TaskState.RUNNING]


class JobInProgress:
    def __init__(self, job_id: JobID, conf_dict: dict,
                 splits: "list[dict]") -> None:
        self.job_id = job_id
        self.conf = dict(conf_dict)
        self.num_reduces = int(_conf_value(self.conf, "mapred.reduce.tasks"))
        self.state = JobState.RUNNING
        self.start_time = time.time()
        self.finish_time = 0.0
        self.counters = Counters()
        self.lock = threading.RLock()
        self.max_map_attempts = int(_conf_value(self.conf,
                                                "mapred.map.max.attempts"))
        self.max_reduce_attempts = int(_conf_value(
            self.conf, "mapred.reduce.max.attempts"))
        #: reduce tasks that must report a map attempt's output
        #: unfetchable before the map is re-executed
        self.max_fetch_failures_per_map = int(_conf_value(
            self.conf, "mapred.max.fetch.failures.per.map"))
        #: map attempt -> the reduce tasks that reported it, below the
        #: threshold
        self._fetch_failures: "dict[str, set[str]]" = {}
        self.slowstart = float(_conf_value(
            self.conf, "mapred.reduce.slowstart.completed.maps"))
        self.priority = normalize_priority(_conf_value(
            self.conf, "mapred.job.priority"))
        self.speculative = _bool(self.conf, "mapred.speculative.execution")
        spec_reduces = self.conf.get("mapred.reduce.speculative.execution")
        self.speculative_reduces = (self.speculative if spec_reduces is None
                                    else _flag(self.conf,
                                               "mapred.reduce.speculative."
                                               "execution"))
        #: targeted (critical-path) speculation, else blanket twins
        self.speculative_targeted = _bool(self.conf,
                                          "tpumr.speculative.targeted")
        self.speculative_cap = max(1, int(_conf_value(
            self.conf, "tpumr.speculative.cap")))
        self._spec_cp_fraction = float(_conf_value(
            self.conf, "tpumr.speculative.critical.fraction"))
        self._rate_alpha = float(_conf_value(self.conf,
                                             "tpumr.speculative.rate.ewma"))
        self.speculative_map_tasks = 0
        self.speculative_reduce_tasks = 0
        #: twins launched, and settled as winners or as wasted
        self.speculative_launched = 0
        self.speculative_won = 0
        self.speculative_wasted = 0
        #: twins not yet terminal
        self._spec_attempts: "set[str]" = set()
        #: running attempts the heartbeat's kill scan ends (twins that
        #: lost, operator kills)
        self._kill_marked: "set[str]" = set()
        #: operator kills to be counted FAILED (``job -fail-task``)
        self._fail_requested: "set[str]" = set()
        #: attempts whose terminal outcome is in the history log
        self.history_logged: "set[str]" = set()
        #: every successful attempt's runtime, for the stats rollup
        self.map_runtimes: "list[tuple[float, bool]]" = []
        self.reduce_runtimes: "list[float]" = []
        self.runtimes_dropped = 0
        self._reduce_time_sum = 0.0
        #: the interrupted job this one was recovered from: attempt ids of
        #: that job count as this job's own
        self.recovered_from: "str | None" = None
        #: monotonic deadline before which no task of this job is handed
        #: out (the recovery grace: rejoining runners report first)
        self.schedule_hold_until = 0.0
        self.error = ""
        self.maps = [TaskInProgress(TaskID(job_id, True, i), i, split=s)
                     for i, s in enumerate(splits)]
        self.reduces = [TaskInProgress(TaskID(job_id, False, r), r)
                        for r in range(self.num_reduces)]
        #: host -> pending-or-not split indexes stored there
        self.host_cache: "dict[str, set[int]]" = {}
        for i, s in enumerate(splits):
            for h in (s or {}).get("locations", []) or []:
                self.host_cache.setdefault(h, set()).add(i)
        self._pending_maps = set(range(len(self.maps)))
        self._pending_reduces = set(range(self.num_reduces))
        #: device or compile failures a map may take on an accelerator slot
        #: before it is pinned to the CPU slots (at least 1)
        self.tpu_attempt_retries = max(1, int(_conf_value(
            self.conf, "tpumr.tpu.attempt.retries")))
        #: distinct maps with such a failure before the job's accelerator
        #: pass is quarantined
        self.tpu_quarantine_tips = max(1, int(_conf_value(
            self.conf, "tpumr.tpu.job.quarantine.tips")))
        #: the job-level accelerator quarantine: the scheduler's accelerator
        #: pass skips the job, and its CPU budget is never starved (else the
        #: job would wait on a pass that never comes)
        self.tpu_disabled = False
        #: maps demoted to the CPU slots
        self._cpu_only_maps: "set[int]" = set()
        #: maps that ever took a device or compile failure
        self._tpu_failed_tips: "set[int]" = set()
        #: demotion and quarantine decisions, drained by the master
        self._accel_events: "list[dict]" = []
        self.finished_maps = 0
        self.finished_reduces = 0
        #: set by the master once the job's output is committed or aborted:
        #: clients see a terminal state only after it
        self.finalized = threading.Event()
        #: claimed under ``lock`` by the one caller that finalizes
        self.finalize_started = False
        # --- per-backend profiling: running sums, O(1) per update
        self.finished_cpu_maps = 0
        self.finished_tpu_maps = 0
        self._cpu_time_sum = 0.0
        self._tpu_time_sum = 0.0
        self._ewma_alpha = float(_conf_value(self.conf,
                                             "tpumr.profile.ewma"))
        self._cpu_ewma = 0.0
        self._tpu_ewma = 0.0
        self.completion_events = CompletionEventFeed()
        #: a pipeline stage whose reduces tee their output for a streamed
        #: downstream stage (the device-shuffled reduce has no tee)
        self.stream_handoff = (
            _flag(self.conf, "tpumr.pipeline.stream.handoff")
            and not _flag(self.conf, "tpumr.shuffle.device"))
        #: committed reduce partitions announced to downstream stages
        self.handoff_events = CompletionEventFeed()
        #: the scheduler's FIFO key: the submit time, or the pipeline's
        #: submit time for a stage job (set by the master)
        self.sched_anchor = self.start_time
        #: (seconds since submit, 'T' | 'c') per map assignment
        self.placement_series: list = []
        self.placement_dropped = 0
        #: heartbeats in which the scheduler gave this job a CPU budget of
        #: 0 (optional scheduling or ``minimize``) while a CPU slot was free
        #: and a map pending: the placements the acceleration factor made
        self.cpu_starved_heartbeats = 0

    # ------------------------------------------------------------ queries

    @property
    def num_maps(self) -> int:
        return len(self.maps)

    def pending_map_count(self) -> int:
        return len(self._pending_maps)

    def pending_reduce_count(self) -> int:
        return len(self._pending_reduces)

    def has_kernel(self) -> bool:
        """The gate of the scheduler's accelerator pass (the reference's
        ``hadoop.pipes.gpu.executable`` gate): only a job naming a kernel
        mapper (``tpumr.map.kernel``) or a pipes GPU executable
        (``tpumr.pipes.tpu.executable``) gets accelerator slots."""
        return bool(self.conf.get("tpumr.map.kernel")
                    or self.conf.get("tpumr.pipes.tpu.executable"))

    def tpu_eligible(self) -> bool:
        """May the accelerator pass offer this job work? The kernel gate
        and the job-level quarantine."""
        return self.has_kernel() and not self.tpu_disabled

    def cpu_pinned_pending_count(self) -> int:
        """Pending maps that only a CPU slot may take (demoted maps): no
        starvation rule may zero the job's CPU budget while there are
        any."""
        with self.lock:
            return len(self._pending_maps & self._cpu_only_maps)

    def has_accel_events(self) -> bool:
        """Whether a drain would find anything (a hint without the lock,
        stale by at most one heartbeat)."""
        return bool(self._accel_events)

    def drain_accel_events(self) -> "list[dict]":
        """The demotion and quarantine decisions since the last drain."""
        with self.lock:
            out, self._accel_events = self._accel_events, []
            return out

    def cpu_map_mean_time(self) -> float:
        """Mean runtime of the finished CPU maps; 0.0 until one finished,
        so that the scheduler assigns unconditionally until then."""
        if self._ewma_alpha and self._cpu_ewma:
            return self._cpu_ewma
        return self._cpu_time_sum / self.finished_cpu_maps \
            if self.finished_cpu_maps else 0.0

    def tpu_map_mean_time(self) -> float:
        if self._ewma_alpha and self._tpu_ewma:
            return self._tpu_ewma
        return self._tpu_time_sum / self.finished_tpu_maps \
            if self.finished_tpu_maps else 0.0

    def acceleration_factor(self) -> float:
        """cpuMean / tpuMean; 1.0 until both backends have a finished map,
        and again once the job's accelerator pass is quarantined."""
        if self.tpu_disabled:
            return 1.0
        cpu, tpu = self.cpu_map_mean_time(), self.tpu_map_mean_time()
        if cpu > 0 and tpu > 0:
            return cpu / tpu
        return 1.0

    def map_progress(self) -> float:
        if not self.maps:
            return 1.0
        running = sum(max((s.progress for s in t.running_attempts()),
                          default=0.0)
                      for t in self.maps if t.state == "running")
        return min(1.0, (self.finished_maps + running) / len(self.maps))

    def reduce_progress(self) -> float:
        if not self.reduces:
            return 1.0
        return self.finished_reduces / len(self.reduces)

    def map_memory_mb(self) -> int:
        return int(_conf_value(self.conf, "mapred.job.map.memory.mb"))

    def reduce_memory_mb(self) -> int:
        return int(_conf_value(self.conf, "mapred.job.reduce.memory.mb"))

    # ------------------------------------------- the remaining-work model

    def speculative_in_flight(self) -> int:
        """Twins launched and not yet terminal."""
        return len(self._spec_attempts)

    def _fold_progress(self, tip: TaskInProgress,
                       status: TaskStatus) -> None:
        """Fold one RUNNING status into the task's progress-rate EWMA, on
        the master's monotonic clock (never the status's own stamps). A
        beat with no advance leaves the anchor, so that the next advance
        averages over the stall. Caller holds ``lock``."""
        now = time.monotonic()
        if tip.dispatch_mono == 0.0:
            tip.dispatch_mono = now   # an adopted or recovered attempt
        p = min(1.0, max(0.0, status.progress))
        if p <= tip.last_progress:
            return
        dt = now - (tip.last_progress_mono or tip.dispatch_mono)
        if dt <= 0.0:
            return
        rate = (p - tip.last_progress) / dt
        a = self._rate_alpha
        tip.rate_ewma = rate if not tip.rate_ewma \
            else a * rate + (1 - a) * tip.rate_ewma
        tip.last_progress = p
        tip.last_progress_mono = now

    @staticmethod
    def _tip_remaining_s(tip: TaskInProgress, now: float,
                         mean_hint: float) -> float:
        """Estimated seconds until a running task ends: from its rate
        EWMA; before the first fold, its age scaled by its progress; with
        no progress at all, a whole mean runtime (a silent task must look
        long)."""
        p = tip.last_progress
        if tip.rate_ewma > 0.0:
            return max(0.0, (1.0 - p) / tip.rate_ewma)
        elapsed = now - (tip.dispatch_mono or now)
        if p > 0.0 and elapsed > 0.0:
            return elapsed * (1.0 - p) / p
        return max(0.0, mean_hint)

    def _remaining_locked(self, tips: "list[TaskInProgress]", now: float,
                          mean_hint: float) -> "dict[int, float]":
        return {t.partition: self._tip_remaining_s(t, now, mean_hint)
                for t in tips if t.state == "running"}

    def _map_mean_locked(self) -> float:
        done = self.finished_cpu_maps + self.finished_tpu_maps
        return ((self._cpu_time_sum + self._tpu_time_sum) / done) \
            if done else 0.0

    def map_remaining_estimates(self) -> "dict[int, float]":
        """partition -> estimated seconds remaining, of each running
        map."""
        with self.lock:
            return self._remaining_locked(self.maps, time.monotonic(),
                                          self._map_mean_locked())

    def critical_path_maps(self) -> "set[int]":
        """The running maps whose remaining estimate is within
        ``tpumr.speculative.critical.fraction`` of the longest."""
        est = self.map_remaining_estimates()
        if not est:
            return set()
        mx = max(est.values())
        if mx <= 0.0:
            return set(est)
        return {p for p, r in est.items()
                if r >= self._spec_cp_fraction * mx}

    def longest_remaining_path_s(self) -> float:
        """The slowest running map's remaining estimate (at least a mean
        runtime while maps are pending), plus the same for the reduces: a
        floor on the job's end, not a promise."""
        with self.lock:
            now = time.monotonic()
            m_mean = self._map_mean_locked()
            m_est = self._remaining_locked(self.maps, now, m_mean)
            path = max(m_est.values(), default=0.0)
            if self._pending_maps:
                path = max(path, m_mean)
            r_mean = self._reduce_time_sum / self.finished_reduces \
                if self.finished_reduces else 0.0
            r_est = self._remaining_locked(self.reduces, now, r_mean)
            rpath = max(r_est.values(), default=0.0)
            if self._pending_reduces:
                rpath = max(rpath, r_mean)
            return path + rpath

    def _note_spec_launch(self, attempt: TaskAttemptID) -> None:
        self.speculative_launched += 1
        self._spec_attempts.add(str(attempt))

    def _settle_speculative(self, aid: str, won: bool) -> None:
        """A twin reached a terminal state. Caller holds ``lock``."""
        if aid in self._spec_attempts:
            self._spec_attempts.discard(aid)
            if won:
                self.speculative_won += 1
            else:
                self.speculative_wasted += 1

    def _held(self) -> bool:
        """Inside the recovery grace. Caller holds ``lock``."""
        return bool(self.schedule_hold_until
                    and time.monotonic() < self.schedule_hold_until)

    # ------------------------------------------------------------ obtain

    def obtain_new_map_task(self, host: str, run_on_tpu: bool,
                            tpu_device_id: int = -1) -> "Task | None":
        """The next pending map for a slot on ``host``: a split stored on
        ``host`` first, else the lowest pending index; an accelerator slot
        skips the demoted maps, and a quarantined job gives it none. Stamps
        the placement on the task's report."""
        with self.lock:
            if self.state != JobState.RUNNING or self._held():
                return None
            if run_on_tpu and self.tpu_disabled:
                return None
            eligible = (self._pending_maps - self._cpu_only_maps
                        if run_on_tpu else self._pending_maps)
            if not self._pending_maps:
                return self._obtain_speculative_map(host, run_on_tpu,
                                                    tpu_device_id)
            if not eligible:
                return None
            local = self.host_cache.get(host, set()) & eligible
            idx = min(local) if local else min(eligible)
            self._pending_maps.discard(idx)
            tip = self.maps[idx]
            tip.state = "running"
            tip.dispatch_mono = tip.dispatch_mono or time.monotonic()
            self._record_placement(run_on_tpu)
            attempt = tip.new_attempt()
            tip.report.state = TaskState.RUNNING
            tip.report.start_time = tip.report.start_time or time.time()
            tip.report.run_on_tpu = run_on_tpu
            tip.report.tpu_device_id = tpu_device_id
            return Task(attempt, partition=idx, num_reduces=self.num_reduces,
                        split=tip.split, num_maps=len(self.maps),
                        run_on_tpu=run_on_tpu, tpu_device_id=tpu_device_id,
                        memory_mb=self.map_memory_mb())

    def _speculation_args(self) -> "tuple[float, float, bool, float]":
        """(lag factor, age floor, targeted, now): what the twin rules
        read."""
        return (float(_conf_value(self.conf, "mapred.speculative.lag.factor")),
                float(_conf_value(self.conf,
                                  "mapred.speculative.min.runtime.s")),
                self.speculative_targeted, time.monotonic())

    def _lagging(self, tip: TaskInProgress, est: "dict[int, float]",
                 max_rem: float, mean: float, factor: float, floor: float,
                 targeted: bool, now: float) -> bool:
        """Does a running task, not yet twinned, earn a twin?"""
        elapsed = now - (tip.dispatch_mono or now)
        if not targeted:
            return elapsed > max(floor, factor * mean)
        if elapsed <= floor:
            return False
        remaining = est.get(tip.partition, 0.0)
        if elapsed + remaining <= factor * mean:
            return False   # its estimated end is within the distribution
        # lagging, and on the critical path
        return not (max_rem > 0.0
                    and remaining < self._spec_cp_fraction * max_rem)

    def _obtain_speculative_map(self, host: str, run_on_tpu: bool,
                                tpu_device_id: int) -> "Task | None":
        """A twin of a lagging running map, once none is pending; one
        twin a map, the first success wins. Caller holds ``lock``."""
        if not self.speculative:
            return None
        if run_on_tpu and self.tpu_disabled:
            return None
        # the profile's own denominator: a quarantine unwinds the
        # accelerator sums and their count together
        done = self.finished_cpu_maps + self.finished_tpu_maps
        if done == 0:
            return None
        mean = (self._cpu_time_sum + self._tpu_time_sum) / done
        factor, floor, targeted, now = self._speculation_args()
        if targeted and len(self._spec_attempts) >= self.speculative_cap:
            return None
        est: "dict[int, float]" = {}
        max_rem = 0.0
        if targeted:
            est = self._remaining_locked(self.maps, now, mean)
            max_rem = max(est.values(), default=0.0)
        for tip in self.maps:
            if tip.state != "running" or tip.next_attempt != 1:
                continue   # one twin a map (or a map that restarted)
            if run_on_tpu and tip.partition in self._cpu_only_maps:
                continue   # a demoted map's twin stays off the card
            if not self._lagging(tip, est, max_rem, mean, factor, floor,
                                 targeted, now):
                continue
            attempt = tip.new_attempt()
            self.speculative_map_tasks += 1
            self._note_spec_launch(attempt)
            self._record_placement(run_on_tpu)
            tip.report.run_on_tpu = run_on_tpu
            tip.report.tpu_device_id = tpu_device_id
            return Task(attempt, partition=tip.partition,
                        num_reduces=self.num_reduces, split=tip.split,
                        num_maps=len(self.maps), run_on_tpu=run_on_tpu,
                        tpu_device_id=tpu_device_id,
                        memory_mb=self.map_memory_mb())
        return None

    def _obtain_speculative_reduce(self) -> "Task | None":
        """A twin of a lagging running reduce, once none is pending, by
        the map rule against the finished reduces' mean. Caller holds
        ``lock``."""
        if not self.speculative_reduces or self.finished_reduces == 0:
            return None
        mean = self._reduce_time_sum / self.finished_reduces
        factor, floor, targeted, now = self._speculation_args()
        if targeted and len(self._spec_attempts) >= self.speculative_cap:
            return None
        est: "dict[int, float]" = {}
        max_rem = 0.0
        if targeted:
            est = self._remaining_locked(self.reduces, now, mean)
            max_rem = max(est.values(), default=0.0)
        for tip in self.reduces:
            if tip.state != "running" or tip.next_attempt != 1:
                continue
            if not self._lagging(tip, est, max_rem, mean, factor, floor,
                                 targeted, now):
                continue
            attempt = tip.new_attempt()
            self.speculative_reduce_tasks += 1
            self._note_spec_launch(attempt)
            return Task(attempt, partition=tip.partition,
                        num_reduces=self.num_reduces,
                        num_maps=len(self.maps),
                        memory_mb=self.reduce_memory_mb())
        return None

    def should_kill_attempt(self, attempt_id: str) -> bool:
        """Did this attempt lose its task's race (another attempt
        succeeded), or is it marked for a kill? (``:786-797``; the
        heartbeat reads :meth:`kill_marked`, which a lost race's late
        report sets.)"""
        with self.lock:
            if attempt_id in self._kill_marked:
                return True
            tip = self.tip_of_attempt(attempt_id)
            return (tip is not None and tip.state == "succeeded"
                    and tip.successful_attempt != attempt_id)

    def kill_marked(self, attempt_id: str) -> bool:
        """Is this running attempt to be killed (a twin that lost, an
        operator kill)? Read without the lock; a mark set meanwhile is
        seen at the next beat."""
        return attempt_id in self._kill_marked

    def request_attempt_kill(self, attempt_id: str,
                             fail: bool = False) -> bool:
        """An operator's kill of one running attempt (``job -kill-task``,
        and with ``fail`` ``-fail-task``, whose report then counts toward
        the task's attempt limit). False for an attempt unknown or already
        ended."""
        with self.lock:
            tip = self.tip_of_attempt(attempt_id)
            if tip is None:
                return False
            st = tip.attempts.get(attempt_id)
            if st is None or st.state in TaskState.TERMINAL:
                return False
            self._kill_marked.add(attempt_id)
            if fail:
                self._fail_requested.add(attempt_id)
            return True

    def obtain_new_reduce_task(self, host: str) -> "Task | None":
        with self.lock:
            if self.state != JobState.RUNNING or self._held():
                return None
            if not self._pending_reduces:
                return self._obtain_speculative_reduce()
            # slow-start: reduces wait for this share of the maps
            if self.finished_maps < self.slowstart * max(1, len(self.maps)):
                return None
            idx = min(self._pending_reduces)
            self._pending_reduces.discard(idx)
            tip = self.reduces[idx]
            tip.state = "running"
            tip.dispatch_mono = tip.dispatch_mono or time.monotonic()
            attempt = tip.new_attempt()
            tip.report.state = TaskState.RUNNING
            tip.report.start_time = tip.report.start_time or time.time()
            return Task(attempt, partition=idx, num_reduces=self.num_reduces,
                        num_maps=len(self.maps),
                        memory_mb=self.reduce_memory_mb())

    # ------------------------------------------------------------ updates

    def update_task_status(self, status: TaskStatus,
                           tracker_shuffle_addr: str = "") -> None:
        with self.lock:
            tip = self._tip_of(status.attempt_id.task)
            if tip is None:
                return
            aid = str(status.attempt_id)
            prev = tip.attempts.get(aid)
            if prev is not None and prev.state in (TaskState.FAILED,
                                                   TaskState.KILLED):
                return   # already settled: a replay must not resurrect it
            if status.state in TaskState.TERMINAL:
                self._kill_marked.discard(aid)
                if status.state == TaskState.KILLED \
                        and aid in self._fail_requested:
                    # job -fail-task: the runner reports the kill, the
                    # operator asked for a failure that counts
                    status = replace(status, state=TaskState.FAILED,
                                     diagnostics=(status.diagnostics
                                                  or "failed by operator "
                                                     "(-fail-task)"))
                self._fail_requested.discard(aid)
            tip.attempts[aid] = status
            tip.report.progress = max(tip.report.progress, status.progress)
            if status.state == TaskState.RUNNING:
                if tip.state == "running":
                    self._fold_progress(tip, status)
                elif tip.state == "succeeded" \
                        and tip.successful_attempt != aid:
                    # a twin that lost, reporting after the winner
                    self._kill_marked.add(aid)
            if status.state == TaskState.SUCCEEDED:
                self._on_success(tip, status, tracker_shuffle_addr)
            elif status.state in (TaskState.FAILED, TaskState.KILLED):
                self._on_failure(tip, status)

    def _tip_of(self, task_id: TaskID) -> "TaskInProgress | None":
        arr = self.maps if task_id.is_map else self.reduces
        return arr[task_id.id] if task_id.id < len(arr) else None

    def tip_of_attempt(self, attempt_id: str) -> "TaskInProgress | None":
        try:
            return self._tip_of(TaskAttemptID.parse(attempt_id).task)
        except (ValueError, IndexError):
            return None

    def _on_success(self, tip: TaskInProgress, status: TaskStatus,
                    shuffle_addr: str) -> None:
        aid = str(status.attempt_id)
        if tip.state == "succeeded":
            # a twin's late success: the first completion won
            self._settle_speculative(aid, won=False)
            return
        tip.state = "succeeded"
        tip.successful_attempt = aid
        self._settle_speculative(aid, won=True)
        # the twins still running lost: the kill scan ends them
        for other_aid, other in tip.attempts.items():
            if other_aid != aid and other.state == TaskState.RUNNING:
                self._kill_marked.add(other_aid)
        tip.report.state = TaskState.SUCCEEDED
        tip.report.progress = 1.0
        tip.report.finish_time = status.finish_time or time.time()
        tip.report.successful_attempt = str(status.attempt_id)
        if status.counters:
            self.counters.merge(Counters.from_dict(status.counters))
        # the task may have been pending here: a restarted master recovers
        # running tasks as pending, and a rejoining runner's first beat can
        # carry the attempt's end
        if tip.is_map:
            self._pending_maps.discard(tip.partition)
            self.finished_maps += 1
            runtime = status.runtime
            self._record_runtime(runtime, on_tpu=bool(status.run_on_tpu))
            a = self._ewma_alpha
            if status.run_on_tpu:
                # after a quarantine an accelerator completion counts in
                # neither profile: the unwound sums must not come back
                if not self.tpu_disabled:
                    self.finished_tpu_maps += 1
                    self._tpu_time_sum += runtime
                    if a:
                        self._tpu_ewma = (runtime if not self._tpu_ewma
                                          else a * runtime
                                          + (1 - a) * self._tpu_ewma)
            else:
                self.finished_cpu_maps += 1
                self._cpu_time_sum += runtime
                if a:
                    self._cpu_ewma = (runtime if not self._cpu_ewma
                                      else a * runtime
                                      + (1 - a) * self._cpu_ewma)
            self.completion_events.append({
                "map_index": tip.partition,
                "attempt_id": str(status.attempt_id),
                "shuffle_addr": shuffle_addr, "status": "SUCCEEDED"})
        else:
            self._pending_reduces.discard(tip.partition)
            self.finished_reduces += 1
            self._reduce_time_sum += status.runtime
            self._record_runtime(status.runtime, is_map=False)
            if self.stream_handoff:
                self.handoff_events.append({
                    "map_index": tip.partition,
                    "attempt_id": str(status.attempt_id),
                    "shuffle_addr": shuffle_addr, "status": "SUCCEEDED"})
        if (self.finished_maps == len(self.maps)
                and self.finished_reduces == len(self.reduces)):
            self.state = JobState.SUCCEEDED
            self.finish_time = time.time()

    _MAX_RUNTIME_SAMPLES = 65536

    def _record_runtime(self, runtime: float, is_map: bool = True,
                        on_tpu: bool = False) -> None:
        """Keep one successful attempt's runtime for the stats rollup.
        Caller holds ``lock``."""
        if len(self.map_runtimes) + len(self.reduce_runtimes) \
                >= self._MAX_RUNTIME_SAMPLES:
            self.runtimes_dropped += 1
            return
        if is_map:
            self.map_runtimes.append((float(runtime), on_tpu))
        else:
            self.reduce_runtimes.append(float(runtime))

    def _on_failure(self, tip: TaskInProgress, status: TaskStatus) -> None:
        # a twin that failed or was killed is wasted either way
        self._settle_speculative(str(status.attempt_id), won=False)
        if tip.state == "succeeded":
            return
        if status.state == TaskState.FAILED:
            # KILLED attempts (lost trackers, lost commit races) do not
            # count toward the attempt limit
            tip.failures += 1
            if (tip.is_map and status.run_on_tpu
                    and status.failure_class in FailureClass.ACCELERATOR):
                self._note_tpu_failure(tip, status)
        limit = (self.max_map_attempts if tip.is_map
                 else self.max_reduce_attempts)
        if status.state == TaskState.FAILED and tip.failures >= limit:
            self.state = JobState.FAILED
            self.finish_time = time.time()
            self.error = (f"task {tip.task_id} failed {tip.failures} times; "
                          f"last: {status.diagnostics}")
            return
        aid = str(status.attempt_id)
        if any(s.state == TaskState.RUNNING and str(s.attempt_id) != aid
               for s in tip.attempts.values()):
            tip.state = "running"   # another attempt is still running
            return
        tip.state = "pending"
        tip.reset_feedback()
        if tip.is_map:
            self._pending_maps.add(tip.partition)
        else:
            self._pending_reduces.add(tip.partition)

    def _note_tpu_failure(self, tip: TaskInProgress,
                          status: TaskStatus) -> None:
        """One device or compile failure of an accelerator attempt: the map
        toward demotion, the job toward quarantine. Caller holds
        ``lock``."""
        tip.tpu_failures += 1
        self._tpu_failed_tips.add(tip.partition)
        if (tip.partition not in self._cpu_only_maps
                and tip.tpu_failures >= self.tpu_attempt_retries):
            self._cpu_only_maps.add(tip.partition)
            self.counters.incr(JobCounter.GROUP, JobCounter.TPU_DEMOTIONS)
            self._accel_events.append({
                "kind": "tip_demoted", "task_id": str(tip.task_id),
                "attempt_id": str(status.attempt_id),
                "failure_class": status.failure_class,
                "tpu_failures": tip.tpu_failures})
        if (not self.tpu_disabled
                and len(self._tpu_failed_tips) >= self.tpu_quarantine_tips):
            # enough distinct maps indict the kernel or the cards: no more
            # accelerator work for this job, and a factor of 1.0, since a
            # poisoned one would keep starving the CPU pass it now needs
            self.tpu_disabled = True
            self.finished_tpu_maps = 0
            self._tpu_time_sum = 0.0
            self._tpu_ewma = 0.0
            self._accel_events.append({
                "kind": "job_tpu_quarantined",
                "failed_tips": len(self._tpu_failed_tips),
                "attempt_id": str(status.attempt_id)})

    def _obsolete_map_output(self, tip: TaskInProgress, aid: str) -> str:
        """Withdraw a published map output: its events marked ``OBSOLETE``
        in place (a reader from cursor 0 sees SUCCEEDED then OBSOLETE) and
        a tombstone appended for the readers past them. Returns the address
        that served it ("" if it was never published). Caller holds
        ``lock``."""
        addr = ""
        for e in self.completion_events:
            if e["attempt_id"] == aid and e.get("status") != "OBSOLETE":
                addr = e.get("shuffle_addr", "")
                e["status"] = "OBSOLETE"
        self.completion_events.append({
            "map_index": tip.partition, "attempt_id": aid,
            "shuffle_addr": addr, "status": "OBSOLETE"})
        return addr

    def _unwind_finished_map(self, tip: TaskInProgress,
                             st: "TaskStatus | None") -> None:
        """Take a finished map out of the books, its backend's runtime sum
        too, so that the re-run is not counted twice in the means. Caller
        holds ``lock``."""
        self.finished_maps -= 1
        if st is not None and st.is_map:
            if st.run_on_tpu:
                self.finished_tpu_maps -= 1
                self._tpu_time_sum -= st.runtime
            else:
                self.finished_cpu_maps -= 1
                self._cpu_time_sum -= st.runtime

    def fetch_failure_notification(self, map_attempt: str,
                                   reduce_attempt: str) -> "dict | None":
        """A reduce attempt reports ``map_attempt``'s output unfetchable.
        None for a report that does not count: an unknown or forged
        reporter (it must be a running reduce attempt of this job), a map
        attempt not (or no longer) the map's success, a job not running.
        Else ``withdrawn`` (the threshold was reached: the attempt failed
        and burned, its output withdrawn, the map pending again),
        ``reexecuted`` (withdrawn and the job goes on), the serving
        ``shuffle_addr`` and the ``reports`` counted."""
        try:
            attempt = TaskAttemptID.parse(map_attempt)
            reducer = TaskAttemptID.parse(reduce_attempt)
        except (ValueError, IndexError):
            return None
        with self.lock:
            if self.state != JobState.RUNNING or not attempt.task.is_map:
                return None
            tip = self._tip_of(attempt.task)
            if tip is None:
                return None
            # an attempt adopted from the job this one was recovered from
            # carries the old job id and counts as this job's
            if reducer.task.is_map or (
                    reducer.task.job != self.job_id
                    and str(reducer.task.job) != (self.recovered_from
                                                  or "")):
                return None
            rtip = self._tip_of(reducer.task)
            rst = rtip.attempts.get(reduce_attempt) \
                if rtip is not None else None
            if rst is None or rst.state != TaskState.RUNNING:
                return None
            if tip.state != "succeeded" \
                    or tip.successful_attempt != map_attempt:
                return None   # stale: already withdrawn
            reporters = self._fetch_failures.setdefault(map_attempt, set())
            # by reduce task: a second attempt of one reduce corroborates
            # nothing new
            reporters.add(str(reducer.task))
            n_reports = len(reporters)
            live_reduces = max(1, len(self.reduces) - self.finished_reduces)
            threshold = min(self.max_fetch_failures_per_map, live_reduces)
            if n_reports < threshold:
                return {"withdrawn": False, "reexecuted": False,
                        "shuffle_addr": "", "reports": n_reports}
            del self._fetch_failures[map_attempt]
            addr = self._obsolete_map_output(tip, map_attempt)
            st = tip.attempts.get(map_attempt)
            if st is not None:
                st.state = TaskState.FAILED
                st.diagnostics = (
                    f"Too many fetch failures: {n_reports} reducer(s) "
                    f"could not fetch this attempt's output from {addr}")
            # burned: a map whose output keeps vanishing fails the job like
            # any task that keeps failing. It did not fail on the device,
            # so it goes back for any slot.
            tip.failures += 1
            tip.state = "pending"
            tip.successful_attempt = ""
            tip.reset_feedback()
            self._unwind_finished_map(tip, st)
            self._pending_maps.add(tip.partition)
            if tip.failures >= self.max_map_attempts:
                self.state = JobState.FAILED
                self.finish_time = time.time()
                self.error = (f"map {tip.task_id} lost its output to "
                              f"fetch failures {tip.failures} times")
                return {"withdrawn": True, "reexecuted": False,
                        "shuffle_addr": addr, "reports": n_reports}
            return {"withdrawn": True, "reexecuted": True,
                    "shuffle_addr": addr, "reports": n_reports}

    def fetch_failure_pending_count(self) -> int:
        """Map attempts with reports below the threshold."""
        with self.lock:
            return len(self._fetch_failures)

    def requeue_lost_attempts(self, attempt_ids: "list[str]") -> "list[str]":
        """A node runner was lost: its running attempts are killed and
        their tasks requeued, and its finished maps too where the job has
        reduces (their outputs lived there). Returns the attempts whose
        published outputs were withdrawn.

        An attempt launched there that never reported a status is killed
        too. The JAX package skips it (``:1329-1340`` there: no status, no
        branch), so its task stays running and the job never ends."""
        withdrawn: "list[str]" = []
        with self.lock:
            for aid in attempt_ids:
                tip = self.tip_of_attempt(aid)
                if tip is None:
                    continue
                self._kill_marked.discard(aid)
                st = tip.attempts.get(aid)
                if st is None and tip.state == "running":
                    st = tip.attempts[aid] = TaskStatus(
                        attempt_id=TaskAttemptID.parse(aid),
                        is_map=tip.is_map)
                if st is not None and st.state == TaskState.RUNNING:
                    # a pending -fail-task holds though the runner died
                    # before the kill reached it
                    if aid in self._fail_requested:
                        st.state = TaskState.FAILED
                        st.diagnostics = (st.diagnostics or "failed by "
                                          "operator (-fail-task)")
                    else:
                        st.state = TaskState.KILLED
                    self._on_failure(tip, st)
                elif (tip.is_map and tip.state == "succeeded"
                      and tip.successful_attempt == aid
                      and self.num_reduces > 0
                      and self.state == JobState.RUNNING):
                    tip.state = "pending"
                    tip.successful_attempt = ""
                    tip.reset_feedback()
                    self._unwind_finished_map(tip, st)
                    self._pending_maps.add(tip.partition)
                    self._obsolete_map_output(tip, aid)
                    self._fetch_failures.pop(aid, None)
                    withdrawn.append(aid)
                self._fail_requested.discard(aid)
        return withdrawn

    def withdraw_handoff_at(self, addr: str) -> int:
        """The runner serving handoff copies at ``addr`` is gone: tombstone
        its announcements, so that downstream readers read the committed
        part files instead (the reduce is not rerun: its output survived
        the runner). Runs for ended jobs too, since a finished stage still
        serves a running pipeline. Returns the partitions withdrawn."""
        if not self.stream_handoff:
            return 0
        with self.lock:
            live = [e for e in self.handoff_events
                    if e.get("shuffle_addr") == addr
                    and e.get("status") != "OBSOLETE"]
            for e in live:
                e["status"] = "OBSOLETE"
                self.handoff_events.append(dict(e))
        return len(live)

    # ------------------------------------------------------------ recovery

    def recover_attempts(self, state: dict, old_job_id: str) -> int:
        """Replay an interrupted job's finished attempts (from
        ``JobHistory.recovered_attempt_state``) into this resubmitted job:
        finished maps succeed under their original attempt ids and their
        completion events are fed again, so that reduces fetch the outputs
        that survived; finished reduces count done (their output is
        committed). A map of a job with reduces and no recorded serving
        address runs again. A recovered output that turns out gone runs
        again through the lost-output protocol. Returns the attempts
        adopted."""
        n = 0
        with self.lock:
            self.recovered_from = old_job_id
            for idx, rec in sorted((state.get("maps") or {}).items()):
                idx = int(idx)
                if idx >= len(self.maps):
                    continue
                if self.num_reduces > 0 and not rec.get("shuffle_addr"):
                    continue
                self._recover_one(self.maps[idx], rec)
                if self.num_reduces > 0:
                    self.completion_events.append({
                        "map_index": idx,
                        "attempt_id": rec["attempt_id"],
                        "shuffle_addr": rec["shuffle_addr"],
                        "status": "SUCCEEDED"})
                n += 1
            for idx, rec in sorted((state.get("reduces") or {}).items()):
                idx = int(idx)
                if idx >= len(self.reduces):
                    continue
                self._recover_one(self.reduces[idx], rec)
                if self.stream_handoff and rec.get("shuffle_addr"):
                    # announce the surviving handoff copy again
                    self.handoff_events.append({
                        "map_index": idx,
                        "attempt_id": rec["attempt_id"],
                        "shuffle_addr": rec["shuffle_addr"],
                        "status": "SUCCEEDED"})
                n += 1
            if (self.finished_maps == len(self.maps)
                    and self.finished_reduces == len(self.reduces)):
                # the old master died between the last task and the
                # commit: the caller finalises, nothing runs again
                self.state = JobState.SUCCEEDED
                self.finish_time = time.time()
        return n

    def _recover_one(self, tip: TaskInProgress, rec: dict) -> None:
        """Adopt one recovered successful attempt into its task. Caller
        holds ``lock``."""
        aid = rec["attempt_id"]
        finish = rec.get("ts") or time.time()
        runtime = float(rec.get("runtime", 0.0) or 0.0)
        status = TaskStatus(
            attempt_id=TaskAttemptID.parse(aid), is_map=tip.is_map,
            state=TaskState.SUCCEEDED, progress=1.0,
            phase=TaskPhase.MAP if tip.is_map else TaskPhase.REDUCE,
            start_time=finish - runtime, finish_time=finish,
            run_on_tpu=bool(rec.get("run_on_tpu", False)),
            tpu_device_id=int(rec.get("tpu_device_id", -1)))
        tip.attempts[aid] = status
        tip.next_attempt = max(tip.next_attempt,
                               int(rec.get("attempt", 0)) + 1)
        tip.state = "succeeded"
        tip.successful_attempt = aid
        tip.report.state = TaskState.SUCCEEDED
        tip.report.progress = 1.0
        tip.report.start_time = status.start_time
        tip.report.finish_time = finish
        tip.report.successful_attempt = aid
        self.history_logged.add(aid)
        if rec.get("counters"):
            self.counters.merge(Counters.from_dict(rec["counters"]))
        if tip.is_map:
            self._pending_maps.discard(tip.partition)
            self.finished_maps += 1
            self._record_runtime(runtime, on_tpu=status.run_on_tpu)
            tip.report.run_on_tpu = status.run_on_tpu
            tip.report.tpu_device_id = status.tpu_device_id
            # the profile starts where the interrupted job's left off
            if status.run_on_tpu:
                self.finished_tpu_maps += 1
                self._tpu_time_sum += runtime
            else:
                self.finished_cpu_maps += 1
                self._cpu_time_sum += runtime
        else:
            self._pending_reduces.discard(tip.partition)
            self.finished_reduces += 1
            self._reduce_time_sum += runtime
            self._record_runtime(runtime, is_map=False)

    def adopt_running_attempt(self, status: TaskStatus) -> bool:
        """A rejoining runner reports ``status`` running, an attempt this
        master never launched (it restarted, or expired the runner): bind
        it to its task so that the work survives, or return False and the
        caller kills that attempt alone (its task succeeded through
        another attempt, it was settled, or the job is over)."""
        with self.lock:
            if self.state != JobState.RUNNING:
                return False
            tip = self._tip_of(status.attempt_id.task)
            if tip is None:
                return False
            aid = str(status.attempt_id)
            if tip.state == "succeeded":
                # only the recorded winner survives
                return tip.successful_attempt == aid
            prev = tip.attempts.get(aid)
            if prev is not None and prev.state in TaskState.TERMINAL:
                return False
            tip.attempts[aid] = status
            tip.next_attempt = max(tip.next_attempt,
                                   status.attempt_id.attempt + 1)
            # the adoption is the best stand-in for the unknown dispatch
            tip.dispatch_mono = tip.dispatch_mono or time.monotonic()
            if tip.state == "pending":
                tip.state = "running"
                if tip.is_map:
                    self._pending_maps.discard(tip.partition)
                else:
                    self._pending_reduces.discard(tip.partition)
            tip.report.state = TaskState.RUNNING
            tip.report.start_time = (tip.report.start_time
                                     or status.start_time or time.time())
            if tip.is_map:
                tip.report.run_on_tpu = status.run_on_tpu
                tip.report.tpu_device_id = status.tpu_device_id
            return True

    def kill(self) -> bool:
        """To KILLED; True only for the caller that made the change."""
        with self.lock:
            if self.state in JobState.TERMINAL:
                return False
            self.state = JobState.KILLED
            self.finish_time = time.time()
            return True

    # ------------------------------------------------------------ wire

    _PLACEMENT_CAP = 50_000

    def _record_placement(self, run_on_tpu: bool) -> None:
        """One map assignment's backend, stamped relative to submission.
        Caller holds ``lock``."""
        if len(self.placement_series) >= self._PLACEMENT_CAP:
            self.placement_dropped += 1
            return
        self.placement_series.append(
            (round(time.time() - self.start_time, 3),
             "T" if run_on_tpu else "c"))

    def placement_timeline(self) -> dict:
        """The assignment sequence ('TcccTT...') and each assignment's
        seconds since submission: the hybrid scheduler's convergence
        curve."""
        with self.lock:
            series = list(self.placement_series)
        return {"seq": "".join(b for _, b in series),
                "t": [t for t, _ in series],
                "dropped": self.placement_dropped}

    def status_dict(self) -> dict:
        with self.lock:
            return {
                "job_id": str(self.job_id),
                "state": self.state,
                "priority": self.priority,
                "map_progress": self.map_progress(),
                "reduce_progress": self.reduce_progress(),
                "finished_maps": self.finished_maps,
                "finished_tpu_maps": self.finished_tpu_maps,
                "finished_cpu_maps": self.finished_cpu_maps,
                "num_maps": len(self.maps),
                "num_reduces": len(self.reduces),
                "cpu_map_mean_time": self.cpu_map_mean_time(),
                "tpu_map_mean_time": self.tpu_map_mean_time(),
                "acceleration_factor": self.acceleration_factor(),
                "longest_remaining_path_s": round(
                    self.longest_remaining_path_s(), 3),
                "speculative_launched": self.speculative_launched,
                "speculative_won": self.speculative_won,
                "speculative_wasted": self.speculative_wasted,
                "speculative_in_flight": len(self._spec_attempts),
                "placement_seq": "".join(
                    b for _, b in self.placement_series[-512:]),
                "cpu_starved_heartbeats": self.cpu_starved_heartbeats,
                "tpu_disabled": self.tpu_disabled,
                "tpu_demoted_tips": len(self._cpu_only_maps),
                "error": self.error,
            }
