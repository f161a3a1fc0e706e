"""Reduce-side execution: the map outputs' segments of this partition,
merged, grouped, reduced and written.

Counterpart of ``tpumr/mapred/reduce_task.py``. The segments come from one
of two sources (``:54-104``): lazy views over the map outputs' files in
this process (a source with ``segments(partition)``:
``shuffle_copier.LocalSegmentSource``), or a chunk source (one with
``chunk_bytes``: ``shuffle_copier.RemoteChunkSource``) that a
``shuffle_copier.ShuffleCopier`` copies from in parallel within its RAM
budget, into a spill directory of the attempt's own, reporting fetch
failures through the source's ``on_fetch_failure`` and stopping at its
``abort_check``. The attempt first passes the ``reduce.task`` fault seam
(``utils/fi``). Whatever ends the attempt, its reducer's setup included,
every segment is closed (releasing the RAM budget, deleting the copy's
spills) and the spill directory removed. The merge is bounded by
``io.sort.factor`` (``io/merger.BoundedMerge``, ``:108-126``), with its
intermediate runs under ``tpumr.task.local.dir`` where the node runner
sets it. It orders by the output-key comparator; the reduce groups run
under the grouping comparator (``mapred.output.value.groupfn.class``)
where the job has one, else under the output-key comparator (``:47-48``).
The attempt runs on its own localised conf
(``map_task.localize_task_conf``), ``tpumr.task.work.dir`` is set before
the reducer is configured, and a reducer with ``begin_task(collector,
reporter)`` is given the collector before the first group, even where
there is none (``:134-138, 173-175``). A failed attempt aborts its reducer
and writer where they can abort, so that a partly fed reducer never
publishes (``KMeansCentroidUpdateReducer`` writes next-round state in
``close``). A streaming pipeline stage's attempt also tees every emitted
record into a ``pipeline.handoff.HandoffWriter`` (``:148-166``), which
the node runner serves to the next stage's maps; a failed attempt aborts
the tee, and :func:`run_reduce_task` returns what the runner registers for
serving.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, Iterator

from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.io.merger import BoundedMerge
from tpumr_torch.io.writable import deserialize
from tpumr_torch.mapred.api import IdentityReducer, OutputCollector, Reporter
from tpumr_torch.mapred.map_task import localize_task_conf
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.shuffle_copier import ShuffleCopier
from tpumr_torch.mapred.task import Task
from tpumr_torch.pipeline.handoff import HandoffWriter
from tpumr_torch.utils.fi import maybe_fail
from tpumr_torch.utils.reflection import new_instance


def run_reduce_task(conf: Any, task: Task, source: Any,
                    reporter: "Reporter | None" = None) -> "dict | None":
    """Execute one reduce attempt over the map outputs' segments of
    ``task.partition`` from ``source`` into the attempt's committer work
    dir. Returns the handoff tee's registration (``HandoffWriter.finish``)
    where the attempt streams its output, else None."""
    reporter = reporter or Reporter()
    conf = localize_task_conf(conf, task)
    maybe_fail("reduce.task", conf)
    sk = conf.get_output_key_comparator().sort_key
    grouping = conf.get_output_value_grouping_comparator()
    gk = grouping.sort_key if grouping is not None else sk
    segments: list = []
    spill_dir = None
    try:
        if hasattr(source, "chunk_bytes"):
            base = conf.get("tpumr.task.local.dir")
            if base:
                spill_dir = os.path.join(base, f"copy-{task.attempt_id}")
            else:
                spill_dir = tempfile.mkdtemp(
                    prefix=f"shuffle-{task.attempt_id}-")
            copier = ShuffleCopier(
                conf, source, task.num_maps, task.partition, spill_dir,
                reporter,
                on_fetch_failure=getattr(source, "on_fetch_failure", None),
                abort_check=getattr(source, "abort_check", None))
            segments = copier.copy_all()
        else:
            segments = list(source.segments(task.partition))
        engine = BoundedMerge(
            segments, sk, conf.sort_factor,
            run_dir=conf.get("tpumr.task.local.dir") or None,
            reporter=reporter, prefix=f"reduce-p{task.partition}")
        try:
            return _reduce_merged(conf, task, iter(engine), gk, reporter)
        finally:
            engine.close()
    finally:
        # whatever failed, reducer setup included, the segments are let go
        # (the budget released, the copy's spills deleted)
        for seg in segments:
            close = getattr(seg, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — cleanup must not mask
                    pass
        if spill_dir is not None:
            shutil.rmtree(spill_dir, ignore_errors=True)


def _reduce_merged(conf: Any, task: Task,
                   merged: Iterator[tuple[bytes, bytes]],
                   gk: Callable[[bytes], Any], reporter: Reporter
                   ) -> "dict | None":
    """Group ``merged`` by ``gk``, reduce and write; commit-ready output in
    the attempt's work dir, and the tee's registration where it streams."""
    wd = FileOutputCommitter(conf).setup_task(str(task.attempt_id))
    conf.set("tpumr.task.work.dir", wd)   # before the reducer's configure
    reducer = new_instance(conf.get_reducer_class() or IdentityReducer, conf)
    writer = new_instance(conf.get_output_format(), conf).get_record_writer(
        conf, wd, task.partition)
    handoff = HandoffWriter.open_for(conf, task)

    def emit(k: Any, v: Any) -> None:
        reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.REDUCE_OUTPUT_RECORDS)
        writer.write(k, v)
        if handoff is not None:
            handoff.append(k, v)

    collector = OutputCollector(emit)
    ok = False
    try:
        # inside the try: a raising begin_task still closes both
        begin = getattr(reducer, "begin_task", None)
        if begin is not None:
            begin(collector, reporter)
        for key, values in group_by_key(merged, gk, reporter):
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
        if handoff is not None and not ok:
            handoff.abort()   # a failed attempt's tee must not linger
    return handoff.finish(task.partition) if handoff is not None else None


def group_by_key(stream: Iterator[tuple[bytes, bytes]],
                 sort_key: Callable[[bytes], Any],
                 reporter: Reporter) -> Iterator[tuple[Any, Iterator[Any]]]:
    """Group a sorted raw stream into (key, lazy values iterator) pairs,
    a group being a run of equal ``sort_key``; its key is the first
    record's. The caller finishes each group before asking for the next."""
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
