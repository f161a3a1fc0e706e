"""The combiner over a sorted map output, one key group at a time.

Counterpart of ``tpumr/mapred/combine.py``. ``MapOutputBuffer`` runs it over
each partition of its spill. The combiner is created for the stream and
closed at its end; it counts ``COMBINE_INPUT_RECORDS`` and
``COMBINE_OUTPUT_RECORDS``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.io.writable import deserialize, serialize
from tpumr_torch.mapred.api import OutputCollector
from tpumr_torch.utils.reflection import new_instance


def combined_stream(conf: Any, combiner_cls: type,
                    sort_key: "Callable[[bytes], Any] | None",
                    stream: Iterable[tuple[bytes, bytes]],
                    reporter: Any) -> Iterator[tuple[bytes, bytes]]:
    """``combiner_cls`` over a SORTED stream of serialized (key, value)
    pairs, yielding its serialized output group by group. Keys group by
    ``sort_key`` (by their bytes when None)."""
    out: "list[tuple[bytes, bytes]]" = []
    collector = OutputCollector(
        lambda k, v: out.append((serialize(k), serialize(v))))
    combiner = new_instance(combiner_cls, conf)
    n_in = n_out = 0
    closed = False
    it = iter(stream)
    group_of = sort_key if sort_key is not None else (lambda kb: kb)
    try:
        head = next(it, None)
        while head is not None:
            first_kb, vb = head
            group_sk = group_of(first_kb)
            group = [vb]
            head = next(it, None)
            while head is not None and group_of(head[0]) == group_sk:
                group.append(head[1])
                head = next(it, None)
            n_in += len(group)
            combiner.reduce(deserialize(first_kb),
                            (deserialize(v) for v in group), collector,
                            reporter)
            n_out += len(out)
            yield from out
            out.clear()
        closed = True
        combiner.close()
        n_out += len(out)       # a combiner may emit on close
        yield from out
        out.clear()
    finally:
        if not closed:
            combiner.close()
        if reporter is not None:
            reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                  TaskCounter.COMBINE_INPUT_RECORDS, n_in)
            reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                  TaskCounter.COMBINE_OUTPUT_RECORDS, n_out)
