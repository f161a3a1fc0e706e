"""User-facing MapReduce API: reporter, collector, mapper, reducer, runner
and partitioner contracts.

Counterpart of ``tpumr/mapred/api.py``, trimmed to what the port's job
paths use. The :class:`Reporter` is the JAX package's whole
(``:31-75``): counters, a status line, progress, liveness ticks that the
node runner's hung-task reaper reads, and the kill flag that record and
batch loops poll (``raise_if_aborted``), since a task thread cannot be
interrupted.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Iterator

from tpumr_torch.core.counters import Counters
from tpumr_torch.io.writable import deserialize, serialize


class TaskKilledError(RuntimeError):
    """Raised inside a task whose attempt was killed (a job kill, a reap, a
    runner stopping): it ends KILLED, or stays as the reaper settled it,
    never FAILED by this error."""


class Reporter:
    """Counters, status and progress of one task attempt, and its kill
    flag. ``ticks`` counts every sign of life (a status line, a progress
    report, a keepalive of a wait that is idle but alive): the reaper
    fails an attempt whose counters, status and ticks stay still for
    ``mapred.task.timeout``."""

    def __init__(self, counters: "Counters | None" = None,
                 on_progress: "Callable[[float], None] | None" = None,
                 abort_check: "Callable[[], bool] | None" = None) -> None:
        self.counters = counters or Counters()
        self._on_progress = on_progress
        self._abort_check = abort_check
        self.status = ""
        self.ticks = 0

    def set_status(self, status: str) -> None:
        self.status = status
        self.ticks += 1

    def keepalive(self) -> None:
        self.ticks += 1

    def progress(self, fraction: "float | None" = None) -> None:
        self.ticks += 1
        if self._on_progress is not None and fraction is not None:
            self._on_progress(fraction)

    def aborted(self) -> bool:
        return self._abort_check is not None and self._abort_check()

    def raise_if_aborted(self) -> None:
        if self.aborted():
            raise TaskKilledError("attempt killed while running")

    def incr_counter(self, group: str, name: str, amount: int = 1) -> None:
        self.counters.incr(group, name, amount)


class OutputCollector:
    """Hands records to ``fn``; ``collect_fixed_rows`` hands ``[n, klen +
    vlen] uint8`` rows over at once where the sink takes them whole
    (``fixed_rows_fn``), else one record at a time."""

    def __init__(self, fn: Callable[[Any, Any], None],
                 fixed_rows_fn: "Callable[[Any, int], None] | None" = None
                 ) -> None:
        self._fn = fn
        self._fixed_rows_fn = fixed_rows_fn

    def collect(self, key: Any, value: Any) -> None:
        self._fn(key, value)

    def collect_fixed_rows(self, rows: Any, klen: int) -> None:
        if self._fixed_rows_fn is not None:
            self._fixed_rows_fn(rows, klen)
            return
        for i in range(rows.shape[0]):
            self._fn(rows[i, :klen].tobytes(), rows[i, klen:].tobytes())


class JobConfigurable:
    def configure(self, conf: Any) -> None:
        pass

    def close(self) -> None:
        pass


class Mapper(JobConfigurable):
    def map(self, key: Any, value: Any, output: OutputCollector,
            reporter: Reporter) -> None:
        raise NotImplementedError


class IdentityMapper(Mapper):
    #: the mapper passes records through untouched: a device-shuffled job
    #: may move its split in bulk (``map_task._identity_dense_fast_path``)
    identity_map = True

    def map(self, key, value, output, reporter):
        output.collect(key, value)


class Reducer(JobConfigurable):
    def reduce(self, key: Any, values: Iterator[Any], output: OutputCollector,
               reporter: Reporter) -> None:
        raise NotImplementedError


class IdentityReducer(Reducer):
    def reduce(self, key, values, output, reporter):
        for v in values:
            output.collect(key, v)


class MapRunnable(JobConfigurable):
    """Runs a map task's whole input: the split's record ``reader`` (a lazy
    iterator of (key, value), read only by a runner that needs records);
    device placement arrives through ``task_ctx``."""

    def run(self, reader: Any, output: OutputCollector, reporter: Reporter,
            task_ctx: Any = None) -> None:
        raise NotImplementedError


class MapRunner(MapRunnable):
    """The per-record runner (``tpumr.mapred.api.MapRunner``): the job's
    mapper class (``mapred.mapper.class``, else the identity) over every
    record of the reader."""

    def configure(self, conf: Any) -> None:
        from tpumr_torch.utils.reflection import new_instance
        self.mapper = new_instance(conf.get_mapper_class() or IdentityMapper,
                                   conf)

    def run(self, reader, output, reporter, task_ctx=None) -> None:
        try:
            for key, value in reader:
                self.mapper.map(key, value, output, reporter)
        finally:
            self.mapper.close()


class Partitioner(JobConfigurable):
    def get_partition(self, key: Any, value: Any, num_partitions: int) -> int:
        raise NotImplementedError


class HashPartitioner(Partitioner):
    """crc32 of the serialized key, modulo the partition count: the JAX
    package's rule, so both send a key to the same reduce."""

    def get_partition(self, key: Any, value: Any, num_partitions: int) -> int:
        return zlib.crc32(serialize(key)) % num_partitions


class KeyFieldBasedPartitioner(Partitioner):
    """crc32 of a text key's first ``num_fields`` fields, modulo the
    partition count (the JAX package's rule)."""

    def __init__(self, num_fields: int = 1, separator: str = "\t") -> None:
        self.num_fields = num_fields
        self.separator = separator

    def get_partition(self, key: Any, value: Any, num_partitions: int) -> int:
        s = key if isinstance(key, str) else str(key)
        prefix = self.separator.join(s.split(self.separator)[:self.num_fields])
        return zlib.crc32(prefix.encode()) % num_partitions


class DeserializingComparator:
    """Default sort order: natural Python order of the deserialized key."""

    def sort_key(self, kbytes: bytes) -> Any:
        return deserialize(kbytes)


class RawComparator:
    """Byte order of the serialized key: the key's own order where its
    serialized form sorts like it (fixed-width ``bytes`` keys)."""

    def sort_key(self, kbytes: bytes) -> Any:
        return kbytes
