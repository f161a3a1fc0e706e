"""LocalJobRunner: a whole job in this process: splits, map tasks, reduce
tasks, commit.

Counterpart of ``tpumr/mapred/local_runner.py``. Map tasks run one after
another. A kernel mapper's tasks run through windows (the path of
``local_runner.py:108-130``): a window of tasks is staged and launched back
to back, every task's output comes to the host in one copy
(``gpu_runner.prelaunch_device_maps``), and each task is then drained
through the normal collect/spill path. Where the window cannot take the job
(a host kernel, an input format without ``read_batch``), the rest of the
job's maps run one by one, each through the per-task device path. A
map-only job (``mapred.reduce.tasks=0``) commits each map attempt's output
and has no reduce phase; in a job with reduces a map attempt that wrote
side files (``lib.MultipleOutputs``) is committed too (``:98-101``). A
device-shuffled job (``JobConf.set_device_shuffle``) is planned at
submission with one gang reduce task
(``device_shuffle.prepare_device_shuffle_job``, on the runner's copy of the
conf), which sorts every map's dense output on the job's device and writes
the job's ranges (``:68-70``, ``:138-151``); any other
job runs one reduce task per partition over lazy views of the maps' IFiles
(``shuffle_copier.LocalSegmentSource``).

The entry points run on ``cuda`` unless the caller asks for the CPU with
``device="cpu"`` or the conf key ``tpumr_torch.device=cpu``
(``tpumr_torch/device.py``). The device decides where a kernel mapper's
tasks run (:func:`maps_on_device`): on ``cuda`` always through the device
runner, whatever ``tpumr.local.run.on.tpu`` says, so a host kernel's maps
(``wordcount``, ``grep``) count as ``TPU_MAP_TASKS`` there. Only on the CPU
does that key choose between the device runner on CPU tensors (set) and the
CPU slots' runners (unset), as the JAX package's key chooses between its
device and its CPU slots.
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from tpumr_torch.core.counters import Counters, JobCounter
from tpumr_torch.device import DEVICE_KEY, select_device
from tpumr_torch.mapred.api import Reporter
from tpumr_torch.mapred.device_shuffle import (is_device_shuffle,
                                               local_dense_fetch,
                                               prepare_device_shuffle_job,
                                               run_device_reduce)
from tpumr_torch.mapred.gpu_runner import prelaunch_device_maps
from tpumr_torch.mapred.ids import JobID, TaskAttemptID, TaskID
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.map_task import run_map_task
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.reduce_task import run_reduce_task
from tpumr_torch.mapred.shuffle_copier import LocalSegmentSource
from tpumr_torch.mapred.task import Task
from tpumr_torch.utils.reflection import new_instance


@dataclass
class JobResult:
    job_id: JobID
    successful: bool
    counters: Counters = field(default_factory=Counters)
    num_maps: int = 0
    num_reduces: int = 0
    wall_time: float = 0.0
    #: seconds of the map phase and of the reduce phase
    map_seconds: float = 0.0
    reduce_seconds: float = 0.0
    #: the gang reduce's stage seconds (``run_device_reduce``), if any
    reduce_stages: dict = field(default_factory=dict)


class LocalJobRunner:
    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, device: "str | torch.device | None" = None) -> None:
        self.device = device

    def submit_job(self, job_conf: Any) -> JobResult:
        conf = JobConf(job_conf)
        if self.device is not None:
            conf.set(DEVICE_KEY, str(self.device))
        device = select_device(conf)   # no CUDA, no CPU asked for: raise
        prepare_device_shuffle_job(conf)
        with LocalJobRunner._seq_lock:
            LocalJobRunner._seq += 1
            job_id = JobID("local", LocalJobRunner._seq)
        t0 = time.monotonic()
        work_root = tempfile.mkdtemp(prefix=f"tpumr_torch-{job_id}-")
        try:
            result = self._run(job_id, conf, device, work_root)
            result.wall_time = time.monotonic() - t0
            return result
        finally:
            shutil.rmtree(work_root, ignore_errors=True)

    def _run(self, job_id: JobID, conf: JobConf, device: torch.device,
             work_root: str) -> JobResult:
        in_fmt = new_instance(conf.get_input_format(), conf)
        new_instance(conf.get_output_format(), conf).check_output_specs(conf)
        splits = in_fmt.get_splits(conf, conf.num_map_tasks_hint)
        num_reduces = conf.num_reduce_tasks
        committer = FileOutputCommitter(conf)
        committer.setup_job()
        counters = Counters()

        run_on_tpu = maps_on_device(conf, device)
        tasks = [
            Task(TaskAttemptID(TaskID(job_id, True, i), 0), partition=i,
                 num_reduces=num_reduces, split=splits[i].to_dict(),
                 run_on_tpu=run_on_tpu, tpu_device_id=0 if run_on_tpu else -1)
            for i in range(len(splits))
        ]
        map_outputs: "list[tuple[str, dict]]" = []

        def one_map(task: Task) -> None:
            reporter = Reporter()
            map_outputs.append(run_map_task(
                conf, task, f"{work_root}/map_{task.partition:06d}",
                reporter))
            task.device_prefetch = None   # free the window's host copy
            if num_reduces == 0 or \
                    committer.needs_commit(str(task.attempt_id)):
                # a map-only job's output, or the side files of a map in a
                # job with reduces (lib.MultipleOutputs)
                committer.commit_task(str(task.attempt_id))
            counters.merge(reporter.counters)
            counters.incr(JobCounter.GROUP, JobCounter.LAUNCHED_MAP_TASKS)

        window = (conf.get_int("tpumr.tpu.pipeline.window", 32)
                  if run_on_tpu else 0)
        t0 = time.monotonic()
        lo = 0
        while lo < len(tasks):
            hi = len(tasks)
            if window > 0:
                pre = prelaunch_device_maps(conf, tasks[lo:lo + window])
                if pre is None:
                    window = 0       # not for the window: one by one
                else:
                    for t, p in zip(tasks[lo:], pre):
                        t.device_prefetch = p
                    hi = lo + len(pre)   # the byte budget may shorten it
            for task in tasks[lo:hi]:
                one_map(task)
            lo = hi

        map_seconds = time.monotonic() - t0

        t0 = time.monotonic()
        stages: dict = {}
        for r in range(num_reduces):
            attempt = TaskAttemptID(TaskID(job_id, False, r), 0)
            task = Task(attempt, partition=r, num_reduces=num_reduces,
                        num_maps=len(splits))
            reporter = Reporter()
            if is_device_shuffle(conf):   # the one gang task
                stages = run_device_reduce(
                    conf, task, local_dense_fetch(map_outputs), reporter)
            else:
                run_reduce_task(conf, task, LocalSegmentSource(map_outputs),
                                reporter)
            committer.commit_task(str(attempt))
            counters.merge(reporter.counters)
            counters.incr(JobCounter.GROUP, JobCounter.LAUNCHED_REDUCE_TASKS)

        committer.commit_job()
        return JobResult(job_id, True, counters, len(splits), num_reduces,
                         map_seconds=map_seconds,
                         reduce_seconds=time.monotonic() - t0,
                         reduce_stages=stages)


def maps_on_device(conf: JobConf, device: torch.device) -> bool:
    """Whether a job's map tasks take the device path: a kernel mapper or a
    pipes GPU executable (``tpumr.pipes.tpu.executable``) is named, and the
    job runs on ``cuda`` or asks for the device path on the CPU with
    ``tpumr.local.run.on.tpu``."""
    return (conf.get_map_kernel() is not None
            or bool(conf.get("tpumr.pipes.tpu.executable"))) and (
        device.type == "cuda" or
        conf.get_boolean("tpumr.local.run.on.tpu", False))


def run_job(conf: Any, device: "str | torch.device | None" = None
            ) -> JobResult:
    """Submit and wait, in this process."""
    return LocalJobRunner(device).submit_job(conf)
