"""Map-side execution: run the split through its runner, partition and sort
the output, combine it and write one IFile spill; or, in a map-only job,
write through the job's output format.

Counterpart of ``tpumr/mapred/map_task.py``. Every attempt runs on its own
copy of the job conf carrying its identity (:func:`localize_task_conf`). The
runner is chosen as the JAX package chooses it (``:248-265``, ``:438-451``):
the device runner for an accelerator task; on a CPU slot the batch runner
when the job names a kernel with a host twin (``map_batch_cpu``) and
``tpumr.cpu.batch.map`` is not false, else the job's per-record runner over
the split's counted reader (:func:`_counted_reader`). The task's output is
written once, at its end, through the job's combiner where it has one
(``MapOutputBuffer.flush``, the single spill of ``:106-145``). Spilling
several times and merging the spills is not ported: a map output that
reaches the point where the JAX package would spill early (``io.sort.mb`` ×
``io.sort.spill.percent``) raises instead of writing a short output.

A device-shuffled job's maps write one dense file each
(``device_shuffle.DenseMapOutputBuffer``, the seam of ``:300-318``); an
identity mapper's split moves there whole as one batch
(:func:`_identity_dense_fast_path`). A mapper class that declares
``map_record_batch`` gets its split as one batch on a CPU slot
(:func:`_host_batch_fast_path`). Both take the flag from the class's own
``__dict__``: a subclass that overrides ``map`` without declaring it again
runs record by record.
"""

from __future__ import annotations

import os
import time
from typing import Any, Iterator

from tpumr_torch.core.counters import BackendCounter, TaskCounter
from tpumr_torch.io import ifile
from tpumr_torch.io.recordbatch import RecordBatch
from tpumr_torch.io.writable import serialize
from tpumr_torch.mapred.api import OutputCollector, Reporter
from tpumr_torch.mapred.device_shuffle import (DenseMapOutputBuffer,
                                               is_device_shuffle)
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.split import DenseSplit, InputSplit
from tpumr_torch.mapred.task import Task
from tpumr_torch.utils.reflection import new_instance


class MapOutputBuffer:
    """In-memory partitioned key/value buffer, written as one sorted
    spill when the task ends, each partition through the job's combiner
    where it has one."""

    def __init__(self, conf: Any, num_partitions: int, local_dir: str,
                 reporter: Reporter) -> None:
        self.conf = conf
        self.n_parts = max(1, num_partitions)
        self.local_dir = local_dir
        self.reporter = reporter
        self.partitioner = new_instance(conf.get_partitioner_class(), conf)
        self.sort_key = conf.get_output_key_comparator().sort_key
        self.combiner_cls = conf.get_combiner_class()
        self._buf: list[tuple[int, bytes, bytes]] = []
        self._bytes = 0
        self._threshold = int(conf.sort_mb * 1024 * 1024 * conf.spill_percent)
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
        """Sort by (partition, key) and write the task's one IFile, each
        non-empty output's partitions through the combiner
        (``combine.combined_stream``). Returns (path, index)."""
        from tpumr_torch.mapred.combine import combined_stream
        sk = self.sort_key
        self._buf.sort(key=lambda rec: (rec[0], sk(rec[1])))
        path = os.path.join(self.local_dir, "file.out")
        with open(path, "wb") as f:
            w = ifile.Writer(f)
            idx = 0
            for part in range(self.n_parts):
                w.start_partition()
                lo = idx
                while idx < len(self._buf) and self._buf[idx][0] == part:
                    idx += 1
                records: Iterator[tuple[bytes, bytes]] = \
                    (rec[1:] for rec in self._buf[lo:idx])
                if self.combiner_cls is not None and self._buf:
                    records = combined_stream(self.conf, self.combiner_cls,
                                              sk, records, self.reporter)
                for kb, vb in records:
                    w.append_raw(kb, vb)
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
    """Execute one map attempt: its runner (module docstring) over the
    split's counted reader; collect into the buffer; write the IFile.
    Returns (output_path, index). A map-only job (``num_reduces == 0``)
    writes through the job's output format into the committer's work dir
    instead and returns ``("", {})``."""
    from tpumr_torch.mapred.gpu_runner import GpuMapRunner
    reporter = reporter or Reporter()
    conf = localize_task_conf(conf, task)
    t0 = time.monotonic()
    if task.run_on_tpu:
        runner_cls = GpuMapRunner
        backend_tasks, backend_ms = (BackendCounter.TPU_MAP_TASKS,
                                     BackendCounter.TPU_MAP_MILLIS)
    else:
        runner_cls = _cpu_runner_class(conf)
        backend_tasks, backend_ms = (BackendCounter.CPU_MAP_TASKS,
                                     BackendCounter.CPU_MAP_MILLIS)
    split = InputSplit.from_dict(task.split) if task.split else None
    in_fmt = new_instance(conf.get_input_format(), conf)

    def run_mapper(collector: OutputCollector) -> None:
        if task.run_on_tpu or not _host_batch_fast_path(
                conf, in_fmt, split, collector, reporter):
            runner = new_instance(runner_cls, conf)
            runner.run(_counted_reader(in_fmt, split, conf, reporter),
                       collector, reporter, task_ctx=task)

    if task.num_reduces == 0:
        wd = FileOutputCommitter(conf).setup_task(str(task.attempt_id))
        writer = new_instance(conf.get_output_format(), conf) \
            .get_record_writer(conf, wd, task.partition)
        ok = False
        try:
            run_mapper(OutputCollector(
                writer.write, getattr(writer, "write_fixed_rows", None)))
            ok = True
        finally:
            # a failed attempt aborts a writer that can (nothing written or
            # published); others close into a work dir never committed
            abort = None if ok else getattr(writer, "abort", None)
            (abort or writer.close)()
        out: tuple[str, dict] = ("", {})
    elif is_device_shuffle(conf):
        buffer = DenseMapOutputBuffer(conf, local_dir, reporter)
        if not _identity_dense_fast_path(conf, in_fmt, split, buffer,
                                         reporter):
            run_mapper(OutputCollector(buffer.collect))
        out = buffer.flush()
    else:
        buffer = MapOutputBuffer(conf, task.num_reduces, local_dir, reporter)
        run_mapper(OutputCollector(buffer.collect))
        out = buffer.flush()
    reporter.incr_counter(BackendCounter.GROUP, backend_tasks)
    reporter.incr_counter(BackendCounter.GROUP, backend_ms,
                          int((time.monotonic() - t0) * 1000))
    return out


def _declared_mapper_class(conf: Any, attr: str) -> "type | None":
    """The job's mapper class where the class itself declares ``attr``
    truthy; an inherited flag does not count."""
    mapper_cls = conf.get_class("mapred.mapper.class")
    if mapper_cls is not None and mapper_cls.__dict__.get(attr):
        return mapper_cls
    return None


def _read_batch_for_fast_path(conf: Any, in_fmt: Any, split: Any
                              ) -> "RecordBatch | None":
    """The split as one :class:`RecordBatch`, or None where the input
    format reads no batches or its batches have no byte keys."""
    if split is None or getattr(in_fmt, "read_batch", None) is None:
        return None
    if isinstance(split, DenseSplit):
        return None
    batch = in_fmt.read_batch(split, conf)
    return batch if isinstance(batch, RecordBatch) else None


def _identity_dense_fast_path(conf: Any, in_fmt: Any, split: Any,
                              buffer: DenseMapOutputBuffer,
                              reporter: Reporter) -> bool:
    """A device-shuffled identity map: the split read as one batch goes
    into the dense buffer as two array appends. False (the caller maps
    record by record, reading the split again) for a mapper that is not
    the identity, an input without batches, or records whose widths are
    not the job's."""
    if _declared_mapper_class(conf, "identity_map") is None:
        return False
    batch = _read_batch_for_fast_path(conf, in_fmt, split)
    if batch is None:
        return False
    n = batch.num_records
    if n == 0:
        return True
    klens = batch.key_offsets[1:] - batch.key_offsets[:-1]
    vlens = batch.value_offsets[1:] - batch.value_offsets[:-1]
    if not ((klens == buffer.klen).all() and (vlens == buffer.vlen).all()):
        return False
    keys, _ = batch.padded_keys(buffer.klen)
    values, _ = batch.padded_values(buffer.vlen)
    buffer.collect_fixed_batch(keys, values)
    reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                          TaskCounter.MAP_INPUT_RECORDS, n)
    return True


def _host_batch_fast_path(conf: Any, in_fmt: Any, split: Any,
                          collector: OutputCollector,
                          reporter: Reporter) -> bool:
    """A mapper class that declares ``map_record_batch(batch, output,
    reporter)`` gets the whole split as one batch (teravalidate's order
    check). False where it does not, or the input has no batches."""
    mapper_cls = _declared_mapper_class(conf, "map_record_batch")
    if mapper_cls is None:
        return False
    batch = _read_batch_for_fast_path(conf, in_fmt, split)
    if batch is None:
        return False
    mapper = new_instance(mapper_cls, conf)
    try:
        mapper.map_record_batch(batch, collector, reporter)
    finally:
        mapper.close()
    reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                          TaskCounter.MAP_INPUT_RECORDS, batch.num_records)
    return True


def _cpu_runner_class(conf: Any) -> type:
    """A CPU slot's runner: the batch runner for a job whose kernel has a
    host twin (``map_batch_cpu``), unless ``tpumr.cpu.batch.map=false``
    opts out; else the job's per-record runner."""
    from tpumr_torch.mapred.gpu_runner import CpuBatchMapRunner
    name = conf.get_map_kernel()
    if name and conf.get_boolean("tpumr.cpu.batch.map", True):
        from tpumr_torch.ops import get_kernel
        if get_kernel(name).map_batch_cpu is not None:
            return CpuBatchMapRunner
    return conf.get_map_runner_class()


def _counted_reader(in_fmt: Any, split: "InputSplit | None", conf: Any,
                    reporter: Reporter) -> Iterator[tuple[Any, Any]]:
    """The split's records, each counted in ``MAP_INPUT_RECORDS`` as it is
    read. Lazy: a runner that stages the split whole never opens it."""
    for k, v in in_fmt.get_record_reader(split, conf, reporter):
        reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.MAP_INPUT_RECORDS)
        yield k, v
