"""The new API: context-object mappers and reducers and the ``Job``
facade, as adapters over the ``mapred`` engine.

Counterpart of ``tpumr/mapreduce/__init__.py``. A user subclasses
:class:`Mapper` or :class:`Reducer` with ``setup``, ``map``/``reduce`` and
``cleanup`` taking a :class:`Context`, and runs a :class:`Job`. The
engine is the old API's: ``_NewApiMapRunner`` drives a mapper's ``run``
over the split, ``_NewApiReducerAdapter`` a reducer, whose ``setup`` runs
at the engine's ``begin_task`` (``:156``), so that a partition with no
group still runs ``setup`` and ``cleanup``. :meth:`Job.set_map_kernel`
(``:208``) names a kernel mapper, whose maps take the device runner as an
old-API kernel job's do. :meth:`Job.wait_for_completion` returns False on
a failed job and does not raise; the error is on ``job.error``
(``:231-244``).
"""

from __future__ import annotations

import sys
from typing import Any, Iterator

from tpumr_torch.mapred import api as old_api
from tpumr_torch.mapred.job_client import run_job as _run_job
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.utils.reflection import new_instance

__all__ = ["Job", "Mapper", "Reducer", "Partitioner", "Context"]


class _Counter:
    __slots__ = ("_reporter", "_group", "_name")

    def __init__(self, reporter, group: str, name: str) -> None:
        self._reporter = reporter
        self._group = group
        self._name = name

    def increment(self, amount: int = 1) -> None:
        self._reporter.incr_counter(self._group, self._name, amount)


class Context:
    """What a task's user code sees: ``write``, counters, the conf, status
    and progress, and the record in hand (``current_key``,
    ``current_value``)."""

    def __init__(self, conf: Any, output: old_api.OutputCollector,
                 reporter: old_api.Reporter) -> None:
        self.conf = conf
        self._output = output
        self._reporter = reporter
        self.current_key: Any = None
        self.current_value: Any = None

    def write(self, key: Any, value: Any) -> None:
        self._output.collect(key, value)

    def get_counter(self, group: str, name: str) -> _Counter:
        return _Counter(self._reporter, group, name)

    def set_status(self, status: str) -> None:
        self._reporter.set_status(status)

    def progress(self) -> None:
        self._reporter.progress()


class Mapper:
    """setup, map (the identity by default), cleanup; ``run`` drives them
    over a split and may be overridden for control of the whole split."""

    def setup(self, context: Context) -> None:
        pass

    def map(self, key: Any, value: Any, context: Context) -> None:
        context.write(key, value)

    def cleanup(self, context: Context) -> None:
        pass

    def run(self, records: Iterator[tuple], context: Context) -> None:
        self.setup(context)
        try:
            for key, value in records:
                context.current_key, context.current_value = key, value
                self.map(key, value, context)
        finally:
            self.cleanup(context)


class Reducer:
    """setup, reduce (the identity by default), cleanup."""

    def setup(self, context: Context) -> None:
        pass

    def reduce(self, key: Any, values: Iterator[Any],
               context: Context) -> None:
        for v in values:
            context.write(key, v)

    def cleanup(self, context: Context) -> None:
        pass


class Partitioner:
    def get_partition(self, key: Any, value: Any, num_partitions: int) -> int:
        raise NotImplementedError


# ------------------------------------------------------------ adapters


class _NewApiMapRunner(old_api.MapRunnable):
    """The engine's map runner for a new-API mapper
    (``tpumr.mapreduce.mapper.class``)."""

    def __init__(self) -> None:
        self.conf: Any = None
        self.mapper: "Mapper | None" = None

    def configure(self, conf: Any) -> None:
        self.conf = conf
        self.mapper = new_instance(
            conf.get_class("tpumr.mapreduce.mapper.class", Mapper))

    def run(self, reader, output, reporter, task_ctx=None) -> None:
        self.mapper.run(iter(reader), Context(self.conf, output, reporter))


class _NewApiReducerAdapter(old_api.Reducer):
    """The engine's reducer for a new-API reducer; ``begin_task`` hands it
    the collector before the first group."""

    _key = "tpumr.mapreduce.reducer.class"

    def configure(self, conf: Any) -> None:
        self._new = new_instance(conf.get_class(self._key, Reducer))
        self._conf = conf
        self._ctx: "Context | None" = None

    def _ensure_ctx(self, output, reporter) -> Context:
        if self._ctx is None:
            self._ctx = Context(self._conf, output, reporter)
            self._new.setup(self._ctx)
        else:
            self._ctx._output = output
            self._ctx._reporter = reporter
        return self._ctx

    def begin_task(self, output, reporter) -> None:
        self._ensure_ctx(output, reporter)

    def reduce(self, key, values, output, reporter):
        self._new.reduce(key, values, self._ensure_ctx(output, reporter))

    def close(self) -> None:
        if self._ctx is not None:
            self._new.cleanup(self._ctx)


class _NewApiCombinerAdapter(_NewApiReducerAdapter):
    _key = "tpumr.mapreduce.combiner.class"


class _NewApiPartitionerAdapter(old_api.Partitioner):
    def configure(self, conf: Any) -> None:
        cls = conf.get_class("tpumr.mapreduce.partitioner.class", None)
        self._new = new_instance(cls, conf) if cls else \
            old_api.HashPartitioner()

    def get_partition(self, key, value, num_partitions):
        return self._new.get_partition(key, value, num_partitions)


# ------------------------------------------------------------ Job facade


class Job:
    """A job's configuration, then :meth:`wait_for_completion`."""

    def __init__(self, conf: "JobConf | None" = None, name: str = "") -> None:
        self.conf = conf or JobConf()
        self.error = ""
        self._result: Any = None
        if name:
            self.conf.set_job_name(name)

    def set_mapper_class(self, cls: type) -> None:
        self.conf.set_class("tpumr.mapreduce.mapper.class", cls)
        self.conf.set_map_runner_class(_NewApiMapRunner)

    def set_reducer_class(self, cls: type) -> None:
        self.conf.set_class("tpumr.mapreduce.reducer.class", cls)
        self.conf.set_reducer_class(_NewApiReducerAdapter)

    def set_combiner_class(self, cls: type) -> None:
        self.conf.set_class("tpumr.mapreduce.combiner.class", cls)
        self.conf.set_combiner_class(_NewApiCombinerAdapter)

    def set_partitioner_class(self, cls: type) -> None:
        self.conf.set_class("tpumr.mapreduce.partitioner.class", cls)
        self.conf.set_partitioner_class(_NewApiPartitionerAdapter)

    def set_map_kernel(self, name: str) -> None:
        """A kernel mapper (``tpumr_torch.ops`` registry) for the maps:
        on ``cuda`` they run on the card."""
        self.conf.set_map_kernel(name)

    def set_input_format(self, cls: type) -> None:
        self.conf.set_input_format(cls)

    def set_output_format(self, cls: type) -> None:
        self.conf.set_output_format(cls)

    def set_num_reduce_tasks(self, n: int) -> None:
        self.conf.set_num_reduce_tasks(n)

    def add_input_path(self, path: str) -> None:
        self.conf.add_input_path(path)

    def set_output_path(self, path: str) -> None:
        self.conf.set_output_path(path)

    def wait_for_completion(self, verbose: bool = False) -> bool:
        """Run the job: True when it succeeded; False when it failed, with
        the error on ``self.error``."""
        try:
            result = _run_job(self.conf)
        except Exception as e:  # noqa: BLE001 — the boolean contract
            self.error = f"{type(e).__name__}: {e}"
            if verbose:
                print(f"job failed: {self.error}", file=sys.stderr)
            return False
        self._result = result
        self.error = "" if result.successful else "job failed"
        return result.successful

    @property
    def counters(self):
        return None if self._result is None else self._result.counters
