"""The reduce-side join: records of several sources joined on a key.

Counterpart of ``tpumr/contrib/datajoin.py``. Each source's
:class:`DataJoinMapper` tags its records with the source's name and keys
them by the join key; :class:`DataJoinReducer` groups one key's values by
tag and calls ``combine`` once for each tuple of the cross product over the
tag groups, emitting what it returns (None drops the tuple). A group
longer than ``datajoin.maxNumOfValuesPerGroup`` (100) is cut there and the
cut values counted (``VALUES_TRUNCATED``); a key that lacks one of
``required_tags`` emits nothing (``KEYS_UNMATCHED``). ``make_datajoin_conf``
builds the job: :class:`PerSourceDispatchMapper` picks each split's mapper
by the split's ``tpumr.task.input.path``, the longest source path that is
it or a directory above it (``/in/users`` does not claim
``/in/users_extra``).
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable

from tpumr_torch.mapred.api import Mapper, Reducer
from tpumr_torch.mapred.lib import longest_prefix
from tpumr_torch.utils.reflection import class_name, resolve_class

MAX_VALUES_KEY = "datajoin.maxNumOfValuesPerGroup"
MAPPERS_KEY = "tpumr.datajoin.mappers"


class TaggedValue:
    """A record and its source's tag; on the wire a (tag, payload)
    tuple."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: str, value: Any) -> None:
        self.tag = tag
        self.value = value


class DataJoinMapper(Mapper):
    """Emits (join key, (tag, value)) for each record of its source.
    Subclasses give :meth:`input_tag` and :meth:`extract_key` (None drops
    the record); :meth:`extract_value` is the record's value."""

    def configure(self, conf) -> None:
        self._conf = conf
        self._tag = self.input_tag(conf)

    def input_tag(self, conf) -> str:
        raise NotImplementedError

    def extract_key(self, key, value) -> Any:
        raise NotImplementedError

    def extract_value(self, key, value) -> Any:
        return value

    def map(self, key, value, output, reporter):
        join_key = self.extract_key(key, value)
        if join_key is None:
            return
        output.collect(join_key,
                       (self._tag, self.extract_value(key, value)))


class DataJoinReducer(Reducer):
    """The cross product of one key's tag groups through
    :meth:`combine`."""

    COUNTER_GROUP = "tpumr.DataJoin"

    #: tags a key must have to emit anything (empty: any it has)
    required_tags: "tuple[str, ...]" = ()

    def configure(self, conf) -> None:
        self._max_per_group = conf.get_int(MAX_VALUES_KEY, 100)

    def combine(self, key, tags: "tuple[str, ...]", values: "tuple[Any, ...]",
                output, reporter) -> Any:
        raise NotImplementedError

    def reduce(self, key, values, output, reporter):
        groups: "dict[str, list[Any]]" = {}
        truncated = 0
        for tag, payload in values:
            group = groups.setdefault(tag, [])
            if len(group) >= self._max_per_group:
                truncated += 1
                continue
            group.append(payload)
        if truncated:
            reporter.incr_counter(self.COUNTER_GROUP, "VALUES_TRUNCATED",
                                  truncated)
        if self.required_tags and any(t not in groups
                                      for t in self.required_tags):
            reporter.incr_counter(self.COUNTER_GROUP, "KEYS_UNMATCHED")
            return
        tags = tuple(sorted(groups))
        for tup in itertools.product(*(groups[t] for t in tags)):
            joined = self.combine(key, tags, tup, output, reporter)
            if joined is not None:
                output.collect(key, joined)
                reporter.incr_counter(self.COUNTER_GROUP, "TUPLES_JOINED")


def make_datajoin_conf(sources: "Iterable[tuple[str, str, type]]",
                       reducer_cls: type, output_path: str,
                       base_conf: Any = None):
    """A join job over ``(tag, input_path, mapper_cls)`` sources."""
    from tpumr_torch.mapred.jobconf import JobConf
    conf = JobConf(base_conf) if base_conf is not None else JobConf()
    paths, tag_map = [], {}
    for _tag, path, mapper_cls in sources:
        if not issubclass(mapper_cls, DataJoinMapper):
            raise TypeError(f"{mapper_cls.__name__} is not a DataJoinMapper")
        paths.append(path)
        tag_map[path] = class_name(mapper_cls)
    conf.set_job_name("datajoin")
    conf.set_input_paths(*paths)
    conf.set_output_path(output_path)
    conf.set(MAPPERS_KEY, tag_map)
    conf.set_mapper_class(PerSourceDispatchMapper)
    conf.set_reducer_class(reducer_cls)
    return conf


class PerSourceDispatchMapper(Mapper):
    """Hands each record to the mapper of the source its split belongs
    to, built at the first record."""

    def configure(self, conf) -> None:
        self._conf = conf
        self._by_prefix = {prefix.rstrip("/"): resolve_class(name)
                           for prefix, name in
                           (conf.get(MAPPERS_KEY) or {}).items()}
        self._delegate: "Mapper | None" = None

    def _resolve(self) -> Mapper:
        if self._delegate is None:
            path = str(self._conf.get("tpumr.task.input.path") or "")
            cls = longest_prefix(self._by_prefix, path)
            if cls is None:
                raise ValueError(
                    f"no datajoin mapper registered for split path {path!r}"
                    f" (sources: {sorted(self._by_prefix)})")
            self._delegate = cls()
            self._delegate.configure(self._conf)
        return self._delegate

    def map(self, key, value, output, reporter):
        self._resolve().map(key, value, output, reporter)

    def close(self) -> None:
        if self._delegate is not None:
            self._delegate.close()
