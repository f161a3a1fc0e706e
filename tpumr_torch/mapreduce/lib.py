"""The new API's helper library: mappers, reducers, partitioners, job
control and lazy output, with the engine's formats under their new-API
names.

Counterpart of ``tpumr/mapreduce/lib.py``:

- :class:`InverseMapper`, :class:`TokenCounterMapper`, :class:`RegexMapper`
  and :class:`MultithreadedMapper` (``:104``): N threads drive ONE inner
  mapper (its ``map`` must be thread-safe), writes are serialised, and the
  first worker error stops the feed and is raised;
- :class:`IntSumReducer` and :class:`LongSumReducer`;
- :class:`HashPartitioner`, :class:`BinaryPartitioner` (crc32 of a byte
  range of the key), :class:`KeyFieldBasedPartitioner` and
  :class:`TotalOrderPartitioner` over ``mapred/total_order.py``;
- :class:`ControlledJob` and :class:`JobControl` (``:254-350``): jobs run one
  at a time as their dependencies succeed; a job whose dependency failed
  ends ``DEPENDENT_FAILED`` without running;
- :class:`LazyOutputFormat` (``:351``): a task that writes nothing makes
  no part file.
"""

from __future__ import annotations

import queue
import threading
import zlib
from typing import Any, Iterator

from tpumr_torch.mapred import api as old_api
from tpumr_torch.mapred.input_formats import (CombineFileInputFormat,
                                              DenseInputFormat,
                                              FileInputFormat,
                                              KeyValueTextInputFormat,
                                              NLineInputFormat,
                                              SequenceFileInputFormat,
                                              TextInputFormat,
                                              WholeFileInputFormat)
from tpumr_torch.mapred.output_formats import (NullOutputFormat,
                                               SequenceFileOutputFormat,
                                               TextOutputFormat)
from tpumr_torch.mapreduce import Context, Job, Mapper, Partitioner, Reducer
from tpumr_torch.utils.reflection import new_instance

__all__ = [
    "FileInputFormat", "TextInputFormat", "KeyValueTextInputFormat",
    "NLineInputFormat", "SequenceFileInputFormat", "CombineFileInputFormat",
    "WholeFileInputFormat", "DenseInputFormat",
    "TextOutputFormat", "SequenceFileOutputFormat", "NullOutputFormat",
    "LazyOutputFormat",
    "InverseMapper", "TokenCounterMapper", "RegexMapper",
    "MultithreadedMapper",
    "IntSumReducer", "LongSumReducer",
    "HashPartitioner", "BinaryPartitioner", "KeyFieldBasedPartitioner",
    "TotalOrderPartitioner",
    "ControlledJob", "JobControl",
]


def _text(value: Any) -> str:
    return value.decode("utf-8", "replace") \
        if isinstance(value, (bytes, bytearray)) else str(value)


# ------------------------------------------------------------------ map


class InverseMapper(Mapper):
    """(k, v) -> (v, k)."""

    def map(self, key: Any, value: Any, context: Context) -> None:
        context.write(value, key)


class TokenCounterMapper(Mapper):
    """(_, text) -> (token, 1) for each whitespace token."""

    def map(self, key: Any, value: Any, context: Context) -> None:
        for tok in _text(value).split():
            context.write(tok, 1)


class RegexMapper(Mapper):
    """(_, text) -> (group, 1) for each match of ``mapreduce.mapper.regex``
    (else ``mapred.mapper.regex``, else ``\\w+``), the group being
    ``mapreduce.mapper.regex.group`` (else ``mapred.mapper.regex.group``,
    else 0)."""

    def setup(self, context: Context) -> None:
        import re
        conf = context.conf
        self._re = re.compile(conf.get("mapreduce.mapper.regex")
                              or conf.get("mapred.mapper.regex") or r"\w+")
        self._group = int(conf.get("mapreduce.mapper.regex.group",
                                   conf.get("mapred.mapper.regex.group", 0)))

    def map(self, key: Any, value: Any, context: Context) -> None:
        for m in self._re.finditer(_text(value)):
            context.write(m.group(self._group), 1)


class MultithreadedMapper(Mapper):
    """``mapreduce.mapper.multithreadedmapper.threads`` threads (10) drive
    one ``mapreduce.mapper.multithreadedmapper.class`` mapper, for mappers
    that wait on I/O."""

    def run(self, records: Iterator[tuple], context: Context) -> None:
        conf = context.conf
        inner: Mapper = new_instance(conf.get_class(
            "mapreduce.mapper.multithreadedmapper.class", Mapper))
        n_threads = max(1, int(conf.get(
            "mapreduce.mapper.multithreadedmapper.threads", 10)))
        lock = threading.Lock()
        raw_write = context.write

        def locked_write(k: Any, v: Any) -> None:
            with lock:
                raw_write(k, v)

        context.write = locked_write  # type: ignore[method-assign]
        work: queue.Queue = queue.Queue(maxsize=n_threads * 2)
        errors: "list[BaseException]" = []
        err_lock = threading.Lock()

        def worker() -> None:
            while True:
                item = work.get()
                if item is None:
                    return
                try:
                    inner.map(item[0], item[1], context)
                except BaseException as e:  # noqa: BLE001 — raised below
                    with err_lock:
                        errors.append(e)

        inner.setup(context)
        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"multithreaded-map-{i}")
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        try:
            for key, value in records:
                with err_lock:
                    if errors:
                        break
                work.put((key, value))
        finally:
            for _ in threads:
                work.put(None)
            for t in threads:
                t.join()
            context.write = raw_write  # type: ignore[method-assign]
            inner.cleanup(context)
        if errors:
            raise errors[0]


# ---------------------------------------------------------------- reduce


class IntSumReducer(Reducer):
    """(k, [n...]) -> (k, sum)."""

    def reduce(self, key: Any, values: Iterator[Any],
               context: Context) -> None:
        context.write(key, sum(int(v) for v in values))


class LongSumReducer(IntSumReducer):
    """:class:`IntSumReducer` under its other name (Python ints do not
    overflow)."""


# ------------------------------------------------------------- partition


class HashPartitioner(Partitioner):
    """The engine's ``HashPartitioner``."""

    def get_partition(self, key: Any, value: Any,
                      num_partitions: int) -> int:
        return old_api.HashPartitioner().get_partition(key, value,
                                                       num_partitions)


class BinaryPartitioner(Partitioner):
    """crc32 of the key's bytes ``left`` to ``right`` inclusive (negative:
    from the end; the whole key by default)."""

    def __init__(self, left: int = 0, right: int = -1) -> None:
        self.left = left
        self.right = right

    def get_partition(self, key: Any, value: Any,
                      num_partitions: int) -> int:
        b = key if isinstance(key, (bytes, bytearray)) else \
            str(key).encode()
        n = len(b)
        lo = self.left if self.left >= 0 else n + self.left
        hi = (self.right if self.right >= 0 else n + self.right) + 1
        return zlib.crc32(bytes(b[lo:hi])) % num_partitions


class KeyFieldBasedPartitioner(Partitioner):
    """The engine's ``KeyFieldBasedPartitioner``."""

    def __init__(self, num_fields: int = 1, separator: str = "\t") -> None:
        self._inner = old_api.KeyFieldBasedPartitioner(num_fields, separator)

    def get_partition(self, key: Any, value: Any,
                      num_partitions: int) -> int:
        return self._inner.get_partition(key, value, num_partitions)


class TotalOrderPartitioner(Partitioner):
    """The engine's ``TotalOrderPartitioner``, over the partition file its
    conf key names; built by name, then ``configure(conf)``."""

    def __init__(self) -> None:
        self._inner: Any = None

    def configure(self, conf: Any) -> None:
        from tpumr_torch.mapred.total_order import \
            TotalOrderPartitioner as _Engine
        self._inner = _Engine()
        self._inner.configure(conf)

    def get_partition(self, key: Any, value: Any,
                      num_partitions: int) -> int:
        if self._inner is None:
            raise RuntimeError("TotalOrderPartitioner not configured "
                               "(no partition file conf)")
        return self._inner.get_partition(key, value, num_partitions)


# ------------------------------------------------------------ jobcontrol


class ControlledJob:
    """A job and the jobs it waits for. WAITING, then READY, RUNNING and
    SUCCESS or FAILED; DEPENDENT_FAILED where a dependency failed."""

    WAITING = "WAITING"
    READY = "READY"
    RUNNING = "RUNNING"
    SUCCESS = "SUCCESS"
    FAILED = "FAILED"
    DEPENDENT_FAILED = "DEPENDENT_FAILED"

    def __init__(self, job: Job, depending: "list[ControlledJob] | None"
                 = None, name: str = "") -> None:
        self.job = job
        self.name = name or job.conf.job_name or f"job-{id(job) & 0xffff}"
        self.depending: "list[ControlledJob]" = list(depending or [])
        self.state = self.WAITING
        self.message = ""

    def add_depending_job(self, dep: "ControlledJob") -> None:
        self.depending.append(dep)

    def _check_state(self) -> str:
        if self.state != self.WAITING:
            return self.state
        if any(d.state in (self.FAILED, self.DEPENDENT_FAILED)
               for d in self.depending):
            self.state = self.DEPENDENT_FAILED
            self.message = "a depending job failed"
        elif all(d.state == self.SUCCESS for d in self.depending):
            self.state = self.READY
        return self.state


class JobControl:
    """Runs its jobs in dependency order: :meth:`run` in the caller's
    thread, or ``threading.Thread(target=jc.run)`` polled through
    :attr:`all_finished` and ended early by :meth:`stop`. One job runs at
    a time."""

    def __init__(self, group_name: str = "jobcontrol") -> None:
        self.group_name = group_name
        self.jobs: "list[ControlledJob]" = []
        self._stop = threading.Event()

    def add_job(self, cj: ControlledJob) -> ControlledJob:
        self.jobs.append(cj)
        return cj

    def add_jobs(self, cjs: "list[ControlledJob]") -> None:
        for cj in cjs:
            self.add_job(cj)

    @property
    def all_finished(self) -> bool:
        return all(cj.state in (ControlledJob.SUCCESS, ControlledJob.FAILED,
                                ControlledJob.DEPENDENT_FAILED)
                   for cj in self.jobs)

    def failed_jobs(self) -> "list[ControlledJob]":
        return [cj for cj in self.jobs
                if cj.state in (ControlledJob.FAILED,
                                ControlledJob.DEPENDENT_FAILED)]

    def successful_jobs(self) -> "list[ControlledJob]":
        return [cj for cj in self.jobs if cj.state == ControlledJob.SUCCESS]

    def stop(self) -> None:
        """Start no further job; the one running finishes."""
        self._stop.set()

    def run(self, poll_s: float = 0.05) -> None:
        while not self.all_finished and not self._stop.is_set():
            progressed = False
            for cj in self.jobs:
                if self._stop.is_set():
                    break
                if cj._check_state() == ControlledJob.READY:
                    cj.state = ControlledJob.RUNNING
                    ok = False
                    try:
                        ok = cj.job.wait_for_completion()
                    except Exception as e:  # noqa: BLE001 — a failed job
                        cj.message = str(e)
                    cj.state = (ControlledJob.SUCCESS if ok
                                else ControlledJob.FAILED)
                    if not ok and not cj.message:
                        cj.message = cj.job.error or "job failed"
                    progressed = True
            if not progressed and not self.all_finished:
                self._stop.wait(poll_s)


# ---------------------------------------------------------------- output


class _LazyWriter:
    def __init__(self, fmt: Any, conf: Any, work_dir: str, partition: int,
                 prefix: str) -> None:
        self._open = lambda: fmt.get_record_writer(conf, work_dir,
                                                   partition, prefix)
        self._writer: Any = None

    def write(self, key: Any, value: Any) -> None:
        if self._writer is None:
            self._writer = self._open()
        self._writer.write(key, value)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class LazyOutputFormat:
    """Makes the real writer (``mapreduce.output.lazyoutputformat.
    outputformat``, text by default) at the first record; set it with
    :meth:`set_output_format_class`."""

    KEY = "mapreduce.output.lazyoutputformat.outputformat"

    @classmethod
    def set_output_format_class(cls, job_or_conf: Any, fmt: type) -> None:
        conf = getattr(job_or_conf, "conf", job_or_conf)
        conf.set_class(cls.KEY, fmt)
        conf.set_class("mapred.output.format.class", cls)

    def _inner(self, conf: Any) -> Any:
        return new_instance(conf.get_class(self.KEY, TextOutputFormat), conf)

    def check_output_specs(self, conf: Any) -> None:
        self._inner(conf).check_output_specs(conf)

    def get_record_writer(self, conf: Any, work_dir: str, partition: int,
                          prefix: str = "part") -> _LazyWriter:
        return _LazyWriter(self._inner(conf), conf, work_dir, partition,
                           prefix)
