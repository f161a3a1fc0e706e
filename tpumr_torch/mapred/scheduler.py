"""Task schedulers: the pluggable SPI and the hybrid CPU/GPU scheduler.

Counterpart of ``tpumr/mapred/scheduler.py`` (the Shirahata hybrid
scheduler of the reference's ``JobQueueTaskScheduler``). Per heartbeat of a
node runner, :meth:`HybridQueueScheduler._assign_tasks` (``:254-415``
there) runs:

- the accelerator pass first: one map per free accelerator slot, each
  given a concrete free device id from the runner's status, consumed
  within the heartbeat; only jobs naming a kernel mapper and not
  quarantined take part (``JobInProgress.tpu_eligible``);
- the CPU pass, up to each job's CPU budget. With
  ``mapred.jobtracker.map.optionalscheduling`` a job's budget drops to 0
  while its pending maps fit the accelerators, ``pending <
  accelerationFactor x accelerator slots x trackers``, so its tail
  converges onto the faster backend; with ``tpumr.scheduler.mode=minimize``
  (cluster or job conf) the budget is the CPU share that minimises
  ``max(ceil(x/n_cpu) t_cpu, ceil(y/n_gpu) t_gpu)``
  (:meth:`HybridQueueScheduler._minimize_cpu_share`, ``:421-441``). A job
  whose accelerator pass is quarantined keeps its whole CPU budget, and
  one with demoted maps pending is never starved and under ``minimize``
  keeps a CPU slot for each (``:295-315``): otherwise no pass could take
  them;
- at most one reduce per heartbeat.

A job with no map (or reduce) pending still takes part in each pass while
its speculation is on (``mapred.speculative.execution``, and
``mapred.reduce.speculative.execution`` for the reduce pass;
``:340-385``): its ``obtain`` call then offers a twin of a lagging task
(``JobInProgress._obtain_speculative_map``), or nothing. The reference's
brownout hold is left out with the brownout.

A node runner that reports ``available_memory_mb`` only receives tasks
whose declared memory fits. Jobs are offered slots in priority, then
submission order, a pipeline's stage jobs at the pipeline's submission
(``:98-106``).

Left out (``ROADMAP.md``): devcache-affinity deferral, the FIFO-order
cache and scheduler metrics.
"""

from __future__ import annotations

import math
from typing import Any, Protocol

from tpumr_torch.mapred.job_in_progress import (JobInProgress, JobState,
                                                priority_rank)
from tpumr_torch.mapred.task import Task


class TaskTrackerManager(Protocol):
    """What a scheduler needs from the master."""

    def running_jobs(self) -> "list[JobInProgress]": ...
    def num_trackers(self) -> int: ...
    def total_slots(self) -> dict: ...   # {"cpu": n, "tpu": n, "reduce": n}


class TaskScheduler:
    """The SPI, pluggable through ``mapred.jobtracker.taskScheduler``."""

    def __init__(self) -> None:
        self.manager: "TaskTrackerManager | None" = None
        self.conf: Any = None

    def set_manager(self, manager: TaskTrackerManager) -> None:
        self.manager = manager

    def configure(self, conf: Any) -> None:
        self.conf = conf

    def assign_tasks(self, tracker_status: dict) -> "list[Task]":
        raise NotImplementedError


def _free_tpu_devices(tracker_status: dict) -> "list[int]":
    """Free device ids, from the runner's status of this heartbeat."""
    avail = tracker_status.get("available_tpu_devices")
    if avail is None:
        avail = [True] * int(tracker_status.get("max_tpu_map_slots", 0))
    return [i for i, free in enumerate(avail) if free]


def _priority_fifo(jobs: "list[JobInProgress]") -> "list[JobInProgress]":
    """Priority first, then the job's ``sched_anchor`` (its submit time, or
    its pipeline's for a stage job, so that a chain's late stages keep the
    chain's place in the queue), then submission time, then job id."""
    return sorted(jobs, key=lambda j: (priority_rank(j.priority),
                                       j.sched_anchor, j.start_time,
                                       str(j.job_id)))


class HybridQueueScheduler(TaskScheduler):
    """FIFO job queue with the hybrid CPU/accelerator map placement."""

    def assign_tasks(self, tts: dict) -> "list[Task]":
        return self._assign_tasks(tts)

    def _assign_tasks(self, tts: dict) -> "list[Task]":
        assert self.manager is not None
        jobs = _priority_fifo([j for j in self.manager.running_jobs()
                               if j.state == JobState.RUNNING])
        if not jobs:
            return []
        n_trackers = max(1, self.manager.num_trackers())
        host = tts.get("host", "")
        max_cpu = int(tts.get("max_cpu_map_slots", 0))
        max_tpu = int(tts.get("max_tpu_map_slots", 0))
        max_red = int(tts.get("max_reduce_slots", 0))
        free_cpu = max(0, max_cpu - int(tts.get("count_cpu_map_tasks", 0)))
        free_tpu = max(0, max_tpu - int(tts.get("count_tpu_map_tasks", 0)))
        free_red = max(0, max_red - int(tts.get("count_reduce_tasks", 0)))
        free_devices = _free_tpu_devices(tts)
        # memory matching: consumed as this heartbeat assigns; -1 = off
        mem_left = int(tts.get("available_memory_mb", -1))

        def fits(demand_mb: int) -> bool:
            return mem_left < 0 or demand_mb <= mem_left

        cluster_mode = (str(self.conf.get("tpumr.scheduler.mode",
                                          "shirahata"))
                        if self.conf else "shirahata")
        cpu_budget: "dict[str, int]" = {}

        def budget_of(job: JobInProgress) -> int:
            jid = str(job.job_id)
            b = cpu_budget.get(jid)
            if b is not None:
                return b
            b = free_cpu
            if job.tpu_eligible():
                accel = job.acceleration_factor()
                mode = str(job.conf.get("tpumr.scheduler.mode",
                                        cluster_mode))
                if mode == "minimize":
                    b = max(self._minimize_cpu_share(job, free_cpu,
                                                     max_tpu * n_trackers),
                            min(free_cpu, job.cpu_pinned_pending_count()))
                elif (self._optional_scheduling(job)
                        and job.cpu_pinned_pending_count() == 0
                        and job.pending_map_count()
                        < accel * max_tpu * n_trackers):
                    b = 0   # starve this job's CPU share
                if b == 0 and job.pending_map_count():
                    # asked with a CPU slot free and a map pending
                    job.cpu_starved_heartbeats += 1
            cpu_budget[jid] = b
            return b

        assigned: "list[Task]" = []
        # accelerator pass first: the scarcer, faster pool
        for _ in range(free_tpu):
            if not free_devices:
                break
            task = None
            for job in jobs:
                if not job.tpu_eligible():
                    continue
                if job.pending_map_count() == 0 and not job.speculative:
                    continue   # drained, and no twins to offer
                if not fits(job.map_memory_mb()):
                    continue
                task = job.obtain_new_map_task(
                    host, run_on_tpu=True, tpu_device_id=free_devices[0])
                if task is not None:
                    free_devices.pop(0)
                    break
            if task is None:
                break
            assigned.append(task)
            if mem_left >= 0:
                mem_left -= task.memory_mb

        for _ in range(free_cpu):
            task = None
            for job in jobs:
                if job.pending_map_count() == 0 and not job.speculative:
                    continue
                if budget_of(job) <= 0:
                    continue
                if not fits(job.map_memory_mb()):
                    continue
                task = job.obtain_new_map_task(host, run_on_tpu=False)
                if task is not None:
                    cpu_budget[str(job.job_id)] -= 1
                    break
            if task is None:
                break
            assigned.append(task)
            if mem_left >= 0:
                mem_left -= task.memory_mb

        if free_red > 0:   # at most one reduce a heartbeat
            for job in jobs:
                if job.pending_reduce_count() == 0 \
                        and not job.speculative_reduces:
                    continue
                if not fits(job.reduce_memory_mb()):
                    continue
                task = job.obtain_new_reduce_task(host)
                if task is not None:
                    assigned.append(task)
                    break
        return assigned

    def _optional_scheduling(self, job: JobInProgress) -> bool:
        return bool(job.conf.get("mapred.jobtracker.map.optionalscheduling",
                                 False))

    def _minimize_cpu_share(self, job: JobInProgress, n_cpu: int,
                            n_tpu_total: int) -> int:
        """How many CPU slots are worth filling this heartbeat: the CPU
        share x of the pending maps that minimises ``max(ceil(x/n_cpu)
        t_cpu, ceil(y/n_tpu) t_tpu)``; ``n_cpu`` without a profile."""
        pending = job.pending_map_count()
        t_cpu = job.cpu_map_mean_time()
        t_tpu = job.tpu_map_mean_time()
        if pending == 0 or t_cpu <= 0 or t_tpu <= 0 or n_tpu_total == 0:
            return n_cpu
        best_x, best_f = 0, math.inf
        for x in range(pending + 1):
            y = pending - x
            f = max(math.ceil(x / max(1, n_cpu)) * t_cpu,
                    math.ceil(y / n_tpu_total) * t_tpu)
            if f < best_f:
                best_x, best_f = x, f
        return min(n_cpu, best_x)


class FifoScheduler(HybridQueueScheduler):
    """Plain FIFO: no starvation and no minimisation; a kernel job still
    takes free accelerator slots."""

    def _optional_scheduling(self, job: JobInProgress) -> bool:
        return False
