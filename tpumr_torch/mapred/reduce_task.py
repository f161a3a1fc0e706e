"""Reduce-side execution: read the map outputs' partition, merge, group,
reduce, write.

Counterpart of ``tpumr/mapred/reduce_task.py``. On the local path each map
output is a file of this process, read directly; on a cluster the reduce
is given a source that fetches each map's segment from the node runner
that serves it (``shuffle_copier.RemoteSegmentSource``);
the merge is a k-way heap merge over the sorted segments; groups follow the
job's output-key comparator. The attempt runs on its own localised conf
(``map_task.localize_task_conf``), and a failed attempt aborts its reducer
and writer where they can abort, so that a partly fed reducer never
publishes (``KMeansCentroidUpdateReducer`` writes next-round state in
``close``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.io import ifile
from tpumr_torch.io.writable import deserialize
from tpumr_torch.mapred.api import IdentityReducer, OutputCollector, Reporter
from tpumr_torch.mapred.map_task import localize_task_conf
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.task import Task
from tpumr_torch.utils.reflection import new_instance


def run_reduce_task(conf: Any, task: Task, map_outputs: Any,
                    reporter: "Reporter | None" = None) -> None:
    """Execute one reduce attempt over ``map_outputs`` into the attempt's
    committer work dir. ``map_outputs`` is the (path, index) of every map
    task's IFile in this process, or a source with
    ``segments(partition)`` that fetches them from the node runners
    (``shuffle_copier.RemoteSegmentSource``)."""
    reporter = reporter or Reporter()
    conf = localize_task_conf(conf, task)
    sk = conf.get_output_key_comparator().sort_key
    fetch = getattr(map_outputs, "segments", None)
    segments = (fetch(task.partition) if fetch is not None else
                [ifile.read_partition(path, index, task.partition)
                 for path, index in map_outputs])
    merged = ifile.merge_sorted(segments, sk)

    wd = FileOutputCommitter(conf).setup_task(str(task.attempt_id))
    reducer = new_instance(conf.get_reducer_class() or IdentityReducer, conf)
    writer = new_instance(conf.get_output_format(), conf).get_record_writer(
        conf, wd, task.partition)

    def emit(k: Any, v: Any) -> None:
        reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.REDUCE_OUTPUT_RECORDS)
        writer.write(k, v)

    collector = OutputCollector(emit)
    ok = False
    try:
        for key, values in group_by_key(merged, sk, reporter):
            reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                  TaskCounter.REDUCE_INPUT_GROUPS)
            reducer.reduce(key, values, collector, reporter)
            for _ in values:   # drain what the reducer left unread
                pass
        ok = True
    finally:
        # a failed attempt goes through abort() where the reducer or the
        # writer has one: close() may publish (the update reducer's next
        # round), and a partly fed attempt must not
        r_abort = None if ok else getattr(reducer, "abort", None)
        (r_abort or reducer.close)()
        w_abort = None if ok else getattr(writer, "abort", None)
        (w_abort or writer.close)()


def group_by_key(stream: Iterator[tuple[bytes, bytes]],
                 sort_key: Callable[[bytes], Any],
                 reporter: Reporter) -> Iterator[tuple[Any, Iterator[Any]]]:
    """Group a sorted raw stream into (key, lazy values iterator) pairs.
    The caller finishes each group before asking for the next."""
    it = iter(stream)
    try:
        first = next(it)
    except StopIteration:
        return
    pending: "list[tuple[bytes, bytes] | None]" = [first]

    while pending[0] is not None:
        head = pending[0]
        group_sk = sort_key(head[0])
        key = deserialize(head[0])

        def values() -> Iterator[Any]:
            while pending[0] is not None and \
                    sort_key(pending[0][0]) == group_sk:
                _kb, vb = pending[0]
                reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                      TaskCounter.REDUCE_INPUT_RECORDS)
                try:
                    pending[0] = next(it)
                except StopIteration:
                    pending[0] = None
                yield deserialize(vb)

        vals = values()
        yield key, vals
        for _ in vals:
            pass
