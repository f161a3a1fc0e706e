"""Map-side execution: run the split through its runner, partition and sort
the output, write one IFile spill; or, in a map-only job, write through the
job's output format.

Counterpart of ``tpumr/mapred/map_task.py``. Every attempt runs on its own
copy of the job conf carrying its identity (:func:`localize_task_conf`). A
K-Means map task emits k records, so its output is written once, at the end
of the task. Spilling several times and merging the spills is not ported: a
map output that reaches the point where the JAX package would spill early
(``io.sort.mb`` × ``io.sort.spill.percent``) raises instead.
"""

from __future__ import annotations

import os
import time
from typing import Any

from tpumr_torch.core.counters import BackendCounter, TaskCounter
from tpumr_torch.io import ifile
from tpumr_torch.io.writable import serialize
from tpumr_torch.mapred.api import OutputCollector, Reporter
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.task import Task
from tpumr_torch.utils.reflection import new_instance


class MapOutputBuffer:
    """In-memory partitioned key/value buffer, written as one sorted
    spill when the task ends."""

    def __init__(self, conf: Any, num_partitions: int, local_dir: str,
                 reporter: Reporter) -> None:
        self.n_parts = max(1, num_partitions)
        self.local_dir = local_dir
        self.reporter = reporter
        self.partitioner = new_instance(conf.get_partitioner_class(), conf)
        self.sort_key = conf.get_output_key_comparator().sort_key
        self._buf: list[tuple[int, bytes, bytes]] = []
        self._bytes = 0
        self._threshold = int(conf.sort_mb * 1024 * 1024 * conf.get_float(
            "io.sort.spill.percent", 0.8))
        os.makedirs(local_dir, exist_ok=True)

    def collect(self, key: Any, value: Any) -> None:
        part = self.partitioner.get_partition(key, value, self.n_parts)
        if not 0 <= part < self.n_parts:
            raise ValueError(f"partition {part} out of range [0,{self.n_parts})")
        kb, vb = serialize(key), serialize(value)
        self._buf.append((part, kb, vb))
        self._bytes += len(kb) + len(vb) + 16
        if self._bytes >= self._threshold:
            raise RuntimeError(
                f"map output reached {self._bytes} bytes (io.sort.mb x "
                "io.sort.spill.percent): spilling more than once is not "
                "ported")
        self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.MAP_OUTPUT_RECORDS)
        self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.MAP_OUTPUT_BYTES,
                                   len(kb) + len(vb))

    def flush(self) -> tuple[str, dict]:
        """Sort by (partition, key) and write the task's one IFile.
        Returns (path, index)."""
        sk = self.sort_key
        self._buf.sort(key=lambda rec: (rec[0], sk(rec[1])))
        path = os.path.join(self.local_dir, "file.out")
        with open(path, "wb") as f:
            w = ifile.Writer(f)
            idx = 0
            for part in range(self.n_parts):
                w.start_partition()
                while idx < len(self._buf) and self._buf[idx][0] == part:
                    w.append_raw(self._buf[idx][1], self._buf[idx][2])
                    idx += 1
                w.end_partition()
            index = w.close()
        if self._buf:
            self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                       TaskCounter.SPILLED_RECORDS,
                                       len(self._buf))
        self._buf.clear()
        self._bytes = 0
        return path, index


def localize_task_conf(conf: Any, task: Task) -> Any:
    """A copy of the job conf for one attempt, with its identity keys set:
    ``tpumr.task.attempt.id``, ``tpumr.task.partition`` and
    ``tpumr.task.is.map``. A copy, so that tasks sharing the job conf never
    see each other's keys."""
    from tpumr_torch.mapred.jobconf import JobConf
    local = JobConf(conf)
    local.set("tpumr.task.attempt.id", str(task.attempt_id))
    local.set("tpumr.task.partition", task.partition)
    local.set("tpumr.task.is.map", task.is_map)
    return local


def run_map_task(conf: Any, task: Task, local_dir: str,
                 reporter: "Reporter | None" = None) -> tuple[str, dict]:
    """Execute one map attempt: the device runner for an accelerator task,
    the CPU batch runner otherwise; collect into the buffer; write the
    IFile. Returns (output_path, index). A map-only job
    (``num_reduces == 0``) writes through the job's output format into the
    committer's work dir instead and returns ``("", {})``."""
    from tpumr_torch.mapred.gpu_runner import CpuBatchMapRunner, GpuMapRunner
    reporter = reporter or Reporter()
    conf = localize_task_conf(conf, task)
    t0 = time.monotonic()
    if task.run_on_tpu:
        runner_cls = GpuMapRunner
        backend_tasks, backend_ms = (BackendCounter.TPU_MAP_TASKS,
                                     BackendCounter.TPU_MAP_MILLIS)
    else:
        runner_cls = CpuBatchMapRunner
        backend_tasks, backend_ms = (BackendCounter.CPU_MAP_TASKS,
                                     BackendCounter.CPU_MAP_MILLIS)
    runner = new_instance(runner_cls, conf)
    if task.num_reduces == 0:
        wd = FileOutputCommitter(conf).setup_task(str(task.attempt_id))
        writer = new_instance(conf.get_output_format(), conf) \
            .get_record_writer(conf, wd, task.partition)
        ok = False
        try:
            runner.run(OutputCollector(writer.write), reporter, task_ctx=task)
            ok = True
        finally:
            # a failed attempt aborts a writer that can (nothing written or
            # published); others close into a work dir never committed
            abort = None if ok else getattr(writer, "abort", None)
            (abort or writer.close)()
        out: tuple[str, dict] = ("", {})
    else:
        buffer = MapOutputBuffer(conf, task.num_reduces, local_dir, reporter)
        runner.run(OutputCollector(buffer.collect), reporter, task_ctx=task)
        out = buffer.flush()
    reporter.incr_counter(BackendCounter.GROUP, backend_tasks)
    reporter.incr_counter(BackendCounter.GROUP, backend_ms,
                          int((time.monotonic() - t0) * 1000))
    return out
