"""Map-side execution: run the split through its runner, then collect,
partition, sort and spill the output, combine each spill, and merge the
spills into the task's one IFile; or, in a map-only job, write through the
job's output format.

Counterpart of ``tpumr/mapred/map_task.py``. Every attempt runs on its own
copy of the job conf carrying its identity (:func:`localize_task_conf`),
with ``tpumr.task.work.dir`` set to its committer work dir (``:271, 297``)
and, for a split of a file, ``tpumr.task.input.path`` to that file's path
(``:241-244``).
The runner is chosen as the JAX package chooses it (``:248-265``,
``:438-451``): for an accelerator task the job's
``mapred.map.runner.tpu.class`` (``GpuMapRunner`` unless a job names
another, as a pipes job names ``PipesGPUMapRunner``); on a CPU slot
the batch runner when the job names a kernel with a host twin
(``map_batch_cpu``) and ``tpumr.cpu.batch.map`` is not false, else the
job's per-record runner over the split's counted reader
(:func:`_counted_reader`). :class:`MapOutputBuffer` is the JAX package's
(``:30-204``): a spill at every crossing of ``io.sort.mb`` ×
``io.sort.spill.percent``, the combiner over each spill, and a
bounded-fan-in merge of several spills at ``io.sort.factor``
(``io/merger.BoundedMerge``), all under the map output's codec
(``mapred.compress.map.output``).

A device-shuffled job's maps write one dense file each
(``device_shuffle.DenseMapOutputBuffer``, the seam of ``:300-318``); an
identity mapper's split moves there whole as one batch
(:func:`_identity_dense_fast_path`). A mapper class that declares
``map_record_batch`` gets its split as one batch on a CPU slot
(:func:`_host_batch_fast_path`). Both take the flag from the class's own
``__dict__``: a subclass that overrides ``map`` without declaring it again
runs record by record.

A map polls its attempt's kill flag (``Reporter.raise_if_aborted``) every
512 records of the counted reader and at the runners' batch boundaries,
and the fault seam ``task.hang`` / ``task.hang.m<index>`` of ``utils/fi``
makes it stop reporting and poll only that flag (:func:`_hang_silently`,
``:234-236, 340-355``), as a hung attempt does until the node runner's
reaper fails it. The seam ``task.slow`` / ``task.slow.m<index>`` makes a
straggler instead (:func:`_run_slowly`, ``:237-239, 322-341``): for
``tpumr.fi.task.slow.ms`` (default 2,000) before its work the map reports
progress creeping toward 0.45, which feeds the master's remaining-work
estimate, and polls the kill flag, so that a speculative twin's win ends
it at once. The attempt's reporter rides on ``task.reporter`` for a
kernel mapper that waits and must stay killable (``examples/sleep``).
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Any, Iterable, Iterator

from tpumr_torch.core.counters import BackendCounter, TaskCounter
from tpumr_torch.io import ifile
from tpumr_torch.io.merger import BoundedMerge
from tpumr_torch.io.recordbatch import RecordBatch
from tpumr_torch.io.writable import serialize
from tpumr_torch.mapred.api import OutputCollector, Reporter
from tpumr_torch.mapred.combine import combined_stream
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.shuffle_copier import spill_region_segment
from tpumr_torch.mapred.split import DenseSplit, InputSplit
from tpumr_torch.mapred.task import Task
from tpumr_torch.utils.fi import fires
from tpumr_torch.utils.reflection import new_instance


class MapOutputBuffer:
    """In-memory partitioned key/value buffer, spilled sorted at every
    threshold crossing and merged into one IFile when the task ends.

    A record counts ``len(k) + len(v) + 16`` bytes against the threshold
    ``io.sort.mb`` MiB × ``io.sort.spill.percent``. The JAX package's
    ``collect_raw_batch`` is not ported: nothing calls it there."""

    def __init__(self, conf: Any, num_partitions: int, local_dir: str,
                 reporter: Reporter) -> None:
        self.conf = conf
        self.n_parts = max(1, num_partitions)
        self.local_dir = local_dir
        self.reporter = reporter
        self.partitioner = new_instance(conf.get_partitioner_class(), conf)
        self.sort_key = conf.get_output_key_comparator().sort_key
        self.combiner_cls = conf.get_combiner_class()
        self.codec = conf.compress_map_output
        self._buf: list[tuple[int, bytes, bytes]] = []
        self._bytes = 0
        self._threshold = int(conf.sort_mb * 1024 * 1024 * conf.spill_percent)
        self._spills: list[tuple[str, dict]] = []
        os.makedirs(local_dir, exist_ok=True)

    def collect(self, key: Any, value: Any) -> None:
        part = self.partitioner.get_partition(key, value, self.n_parts)
        if not 0 <= part < self.n_parts:
            raise ValueError(f"partition {part} out of range [0,{self.n_parts})")
        kb, vb = serialize(key), serialize(value)
        self._buf.append((part, kb, vb))
        self._bytes += len(kb) + len(vb) + 16
        if self._bytes >= self._threshold:
            self.sort_and_spill()

    def sort_and_spill(self) -> None:
        """Sort the buffer by (partition, key) and write it as
        ``spill{N}.out``, each partition through the combiner where the
        job has one. ``SPILLED_RECORDS`` counts the buffered records, and
        the map output counters are brought up to date (once a spill,
        not once a record)."""
        if not self._buf:
            return
        group = TaskCounter.FRAMEWORK_GROUP
        self.reporter.incr_counter(group, TaskCounter.MAP_OUTPUT_RECORDS,
                                   len(self._buf))
        self.reporter.incr_counter(group, TaskCounter.MAP_OUTPUT_BYTES,
                                   self._bytes - 16 * len(self._buf))
        sk = self.sort_key
        self._buf.sort(key=lambda rec: (rec[0], sk(rec[1])))
        path = os.path.join(self.local_dir, f"spill{len(self._spills)}.out")
        with open(path, "wb") as f:
            w = ifile.Writer(f, codec=self.codec)
            idx = 0
            for part in range(self.n_parts):
                w.start_partition()
                lo = idx
                while idx < len(self._buf) and self._buf[idx][0] == part:
                    idx += 1
                for kb, vb in self._combined(
                        rec[1:] for rec in self._buf[lo:idx]):
                    w.append_raw(kb, vb)
                w.end_partition()
            index = w.close()
        self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.SPILLED_RECORDS,
                                   len(self._buf))
        self._spills.append((path, index))
        self._buf.clear()
        self._bytes = 0

    def _combined(self, records: Iterable[tuple[bytes, bytes]]
                  ) -> Iterator[tuple[bytes, bytes]]:
        """``records`` through the job's combiner, if it has one."""
        if self.combiner_cls is None:
            return iter(records)
        return combined_stream(self.conf, self.combiner_cls, self.sort_key,
                               records, self.reporter)

    def flush(self) -> tuple[str, dict]:
        """Spill what is buffered, then make the task's ``file.out``: with
        no spill, ``n`` empty partitions; with one, the spill renamed (its
        combiner is not run again); with more, their merge
        (:meth:`_merge_spills`). Returns (path, index)."""
        self.sort_and_spill()
        final_path = os.path.join(self.local_dir, "file.out")
        if not self._spills:
            with open(final_path, "wb") as f:
                w = ifile.Writer(f, codec=self.codec)
                for _ in range(self.n_parts):
                    w.start_partition()
                    w.end_partition()
                index = w.close()
            return final_path, index
        if len(self._spills) == 1:
            path, index = self._spills[0]
            os.replace(path, final_path)
            return final_path, index
        return self._merge_spills(final_path)

    def _merge_spills(self, final_path: str) -> tuple[str, dict]:
        """Each partition of every spill, streamed from the spill files
        and merged at ``io.sort.factor`` (intermediate runs under
        ``merge-tmp``), through the combiner again, into ``final_path``.
        The spills and ``merge-tmp`` are removed afterwards, and
        ``merge-tmp`` also when the merge fails."""
        run_dir = os.path.join(self.local_dir, "merge-tmp")
        try:
            with open(final_path, "wb") as f:
                w = ifile.Writer(f, codec=self.codec)
                for part in range(self.n_parts):
                    w.start_partition()
                    segs = [spill_region_segment(p, idx, part)
                            for p, idx in self._spills]
                    bm = BoundedMerge(segs, self.sort_key,
                                      self.conf.sort_factor,
                                      run_dir=run_dir,
                                      reporter=self.reporter,
                                      prefix=f"spill-p{part}")
                    try:
                        for kb, vb in self._combined(iter(bm)):
                            w.append_raw(kb, vb)
                    finally:
                        bm.close()
                    w.end_partition()
                index = w.close()
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        for p, _ in self._spills:
            os.remove(p)
        return final_path, index


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
    reporter = reporter or Reporter()
    task.reporter = reporter
    conf = localize_task_conf(conf, task)
    if fires("task.hang", conf) or fires(f"task.hang.m{task.partition}",
                                         conf):
        _hang_silently(reporter)
    if fires("task.slow", conf) or fires(f"task.slow.m{task.partition}",
                                         conf):
        _run_slowly(conf, reporter)
    t0 = time.monotonic()
    if task.run_on_tpu:
        runner_cls = conf.get_tpu_map_runner_class()
        backend_tasks, backend_ms = (BackendCounter.TPU_MAP_TASKS,
                                     BackendCounter.TPU_MAP_MILLIS)
    else:
        runner_cls = _cpu_runner_class(conf)
        backend_tasks, backend_ms = (BackendCounter.CPU_MAP_TASKS,
                                     BackendCounter.CPU_MAP_MILLIS)
    split = InputSplit.from_dict(task.split) if task.split else None
    if split is not None and getattr(split, "path", None):
        # the split's source path, before any mapper is built, for mappers
        # that pick a delegate by input (lib.DelegatingMapper,
        # contrib.datajoin) ≈ map.input.file (``:241-244``)
        conf.set("tpumr.task.input.path", str(split.path))
    in_fmt = new_instance(conf.get_input_format(), conf)

    def run_mapper(collector: OutputCollector) -> None:
        if task.run_on_tpu or not _host_batch_fast_path(
                conf, in_fmt, split, collector, reporter):
            runner = new_instance(runner_cls, conf)
            runner.run(_counted_reader(in_fmt, split, conf, reporter),
                       collector, reporter, task_ctx=task)

    if task.num_reduces == 0:
        wd = FileOutputCommitter(conf).setup_task(str(task.attempt_id))
        conf.set("tpumr.task.work.dir", wd)   # lib.MultipleOutputs' seam
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
    else:
        if conf.get("mapred.output.dir"):
            # side files of a job with reduces go to the attempt's work
            # dir, made only where something writes there
            conf.set("tpumr.task.work.dir", FileOutputCommitter(
                conf).work_dir(str(task.attempt_id)))
        if conf.device_shuffle:
            # imported here: a CPU task in a process of its own loads no
            # torch
            from tpumr_torch.mapred.device_shuffle import DenseMapOutputBuffer
            buffer: Any = DenseMapOutputBuffer(conf, local_dir, reporter)
            if not _identity_dense_fast_path(conf, in_fmt, split, buffer,
                                             reporter):
                run_mapper(OutputCollector(buffer.collect))
        else:
            buffer = MapOutputBuffer(conf, task.num_reduces, local_dir,
                                     reporter)
            run_mapper(OutputCollector(buffer.collect))
        out = buffer.flush()
    reporter.incr_counter(BackendCounter.GROUP, backend_tasks)
    reporter.incr_counter(BackendCounter.GROUP, backend_ms,
                          int((time.monotonic() - t0) * 1000))
    return out


def _run_slowly(conf: Any, reporter: Reporter) -> None:
    """The ``task.slow`` fault: a straggler, alive and reporting, whose
    progress creeps toward (never past) 0.45 for ``tpumr.fi.task.slow.ms``
    before the real work; the kill flag is polled every 50 ms."""
    total_s = max(0.0, conf.get_int("tpumr.fi.task.slow.ms", 2000) / 1000.0)
    t0 = time.monotonic()
    while True:
        elapsed = time.monotonic() - t0
        if elapsed >= total_s:
            return
        reporter.progress(min(0.45, 0.45 * elapsed / total_s))
        reporter.raise_if_aborted()
        time.sleep(min(0.05, total_s - elapsed))


def _hang_silently(reporter: Reporter) -> None:
    """The ``task.hang`` fault: no progress, status or counter from here
    on, only the kill flag polled, so that the reaper's kill ends the
    thread."""
    while True:
        reporter.raise_if_aborted()
        time.sleep(0.05)


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
                              buffer: "DenseMapOutputBuffer",
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
    if (conf.get_map_kernel()
            and conf.get_boolean("tpumr.cpu.batch.map", True)):
        from tpumr_torch.mapred.gpu_runner import (CpuBatchMapRunner,
                                                   job_kernel)
        if job_kernel(conf).map_batch_cpu is not None:
            return CpuBatchMapRunner
    return conf.get_map_runner_class()


def _counted_reader(in_fmt: Any, split: "InputSplit | None", conf: Any,
                    reporter: Reporter) -> Iterator[tuple[Any, Any]]:
    """The split's records, each counted in ``MAP_INPUT_RECORDS`` as it is
    read, the kill flag polled every 512. Lazy: a runner that stages the
    split whole never opens it."""
    for i, (k, v) in enumerate(in_fmt.get_record_reader(split, conf,
                                                        reporter)):
        if (i & 0x1FF) == 0:
            reporter.raise_if_aborted()
        reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.MAP_INPUT_RECORDS)
        yield k, v
