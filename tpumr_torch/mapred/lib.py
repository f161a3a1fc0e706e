"""The old-API helper library: small mappers, field selection, the key
field comparator, chains, multiple inputs and outputs, and the aggregate
reducers.

Counterpart of ``tpumr/mapred/lib.py``:

- :class:`InverseMapper`, :class:`TokenCountMapper`, :class:`RegexMapper`
  and :class:`FieldSelectionMapReduce` (``:45-131``), the last with the
  spec ``"keyFields:valueFields"`` over 0-based fields (``n-`` is n to the
  last field);
- :class:`KeyFieldBasedComparator` (``:159``): Unix sort's ``-kPOS1[,POS2]``
  with ``n`` (numeric) and ``r`` (reverse) over 1-based key fields;
  ``KeyFieldBasedPartitioner`` is ``mapred/api.py``'s;
- :class:`ChainMapper` and :class:`ChainReducer` (``:216-300``): mappers in
  one task, ``[MAP+ / REDUCE MAP*]``, each collect feeding the next;
- :class:`MultipleInputs` and :class:`DelegatingMapper` (``:305-350``): a
  mapper class per input path, picked by the split's
  ``tpumr.task.input.path`` (longest prefix at a ``/`` boundary);
- :class:`MultipleOutputs` (``:359-400``): named side files beside the
  task's part file, through the job's output format into the attempt's
  work dir, numbered by ``tpumr.task.partition`` and committed with it;
- the aggregate framework (``:407-514``): mappers emit
  ``("<TYPE>:<id>", value)`` and :class:`ValueAggregatorReducer` folds each
  group with the named aggregator; streaming's ``-reducer aggregate`` is
  this reducer with :class:`ValueAggregatorCombiner`.
"""

from __future__ import annotations

import functools
import re
from collections import Counter
from typing import Any

from tpumr_torch.io.writable import deserialize
from tpumr_torch.mapred.api import (KeyFieldBasedPartitioner, Mapper,
                                    OutputCollector, Reducer)
from tpumr_torch.utils.reflection import (class_name, new_instance,
                                          resolve_class)

__all__ = ["InverseMapper", "TokenCountMapper", "RegexMapper",
           "FieldSelectionMapReduce", "KeyFieldBasedComparator",
           "KeyFieldBasedPartitioner", "ChainMapper", "ChainReducer",
           "MultipleInputs", "DelegatingMapper", "MultipleOutputs",
           "ValueAggregatorReducer", "ValueAggregatorCombiner",
           "AGGREGATORS"]


def _text(value: Any) -> str:
    return value.decode("utf-8", "replace") \
        if isinstance(value, (bytes, bytearray)) else str(value)


class InverseMapper(Mapper):
    """(k, v) -> (v, k)."""

    def map(self, key, value, output, reporter):
        output.collect(value, key)


class TokenCountMapper(Mapper):
    """(_, text) -> (token, 1) for each whitespace token."""

    def map(self, key, value, output, reporter):
        for tok in _text(value).split():
            output.collect(tok, 1)


class RegexMapper(Mapper):
    """(_, text) -> (group, 1) for each match of ``mapred.mapper.regex``,
    the group being ``mapred.mapper.regex.group`` (0 by default)."""

    def configure(self, conf) -> None:
        self._re = re.compile(conf.get("mapred.mapper.regex", ""))
        self._group = conf.get_int("mapred.mapper.regex.group", 0)

    def map(self, key, value, output, reporter):
        for m in self._re.finditer(_text(value)):
            output.collect(m.group(self._group), 1)


# ------------------------------------------------------- field selection


def _parse_field_spec(spec: str) -> "list[tuple[int, int | None]]":
    """"2,3-4,6-" -> [(2, 2), (3, 4), (6, None)]; None is the last field."""
    out: "list[tuple[int, int | None]]" = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        lo, sep, hi = part.partition("-")
        if not sep:
            out.append((int(lo), int(lo)))
        else:
            out.append((int(lo), int(hi) if hi.strip() else None))
    return out


def _select(fields: "list[str]",
            ranges: "list[tuple[int, int | None]]") -> "list[str]":
    picked: "list[str]" = []
    for lo, hi in ranges:
        picked.extend(fields[lo:len(fields) if hi is None else hi + 1])
    return picked


class FieldSelectionMapReduce(Mapper, Reducer):
    """Both phases split a record on ``mapred.data.field.separator`` (TAB)
    and emit the fields that ``mapred.text.key.value.fields.spec``
    (``"0:1-"`` by default) selects as key and as value; the reduce emits
    each value under its key."""

    def configure(self, conf) -> None:
        self._sep = str(conf.get("mapred.data.field.separator", "\t"))
        spec = str(conf.get("mapred.text.key.value.fields.spec", "0:1-"))
        key_spec, _, val_spec = spec.partition(":")
        self._key_ranges = _parse_field_spec(key_spec)
        self._val_ranges = _parse_field_spec(val_spec)

    def map(self, key, value, output, reporter):
        fields = _text(value).split(self._sep)
        output.collect(self._sep.join(_select(fields, self._key_ranges)),
                       self._sep.join(_select(fields, self._val_ranges)))

    def reduce(self, key, values, output, reporter):
        for v in values:
            output.collect(key, v)


# ---------------------------------------------------- key-field comparator


_KEY_OPT = re.compile(r"-k\s*(\d+)(?:\.(\d+))?(?:,(\d+)(?:\.(\d+))?)?([nr]*)")


@functools.total_ordering
class _SpecKey:
    """A sort key of (comparable, reverse) parts."""

    __slots__ = ("parts",)

    def __init__(self, parts: "list[tuple[Any, bool]]") -> None:
        self.parts = parts

    def __eq__(self, other) -> bool:
        return self.parts == other.parts

    def __lt__(self, other) -> bool:
        for (a, rev), (b, _) in zip(self.parts, other.parts):
            if a == b:
                continue
            return (a > b) if rev else (a < b)
        return len(self.parts) < len(other.parts)


class KeyFieldBasedComparator:
    """Orders text keys by ``mapred.text.key.comparator.options``, e.g.
    ``-k2,2nr -k1,1``: 1-based fields over
    ``map.output.key.field.separator`` (TAB), ``-k2`` meaning field 2 to
    the end of the key; ``n`` numeric (a non-number sorts first), ``r``
    reversed. Character offsets (``-k1.3``) raise ``ValueError``."""

    def __init__(self, conf: Any = None) -> None:
        opts, self._sep = "", "\t"
        if conf is not None:
            opts = str(conf.get("mapred.text.key.comparator.options", ""))
            self._sep = str(conf.get("map.output.key.field.separator",
                                     "\t"))
        self._specs = []
        for m in _KEY_OPT.finditer(opts):
            if m.group(2) or m.group(4):
                raise ValueError(
                    f"char offsets in {m.group(0)!r} are not supported — "
                    "use whole-field specs (-kPOS1[,POS2][nr])")
            end = int(m.group(3)) if m.group(3) else 10 ** 9
            self._specs.append((int(m.group(1)), end,
                                "n" in m.group(5), "r" in m.group(5)))
        self._specs = self._specs or [(1, 10 ** 9, False, False)]

    def configure(self, conf) -> None:
        self.__init__(conf)

    def sort_key(self, kbytes: bytes) -> _SpecKey:
        fields = _text(deserialize(kbytes)).split(self._sep)
        parts: "list[tuple[Any, bool]]" = []
        for start, end, numeric, rev in self._specs:
            sel = self._sep.join(fields[start - 1:end])
            if numeric:
                try:
                    val: Any = (1, float(sel))
                except ValueError:
                    val = (0, 0.0)
                parts.append((val, rev))
            else:
                parts.append((sel, rev))
        return _SpecKey(parts)


# ----------------------------------------------------------------- chain


def _chain_step(mapper: Mapper, downstream: Any, reporter: Any,
                key: Any, value: Any) -> None:
    mapper.map(key, value, downstream, reporter)


def _wire(mappers: "list[Mapper]", output: Any, reporter: Any
          ) -> OutputCollector:
    """The collector that feeds ``mappers`` in order into ``output``."""
    nxt: Any = output
    for mapper in reversed(mappers):
        nxt = OutputCollector(functools.partial(_chain_step, mapper, nxt,
                                                reporter))
    return nxt


class ChainMapper(Mapper):
    """The mappers named in ``tpumr.chain.mappers`` (:meth:`add_mapper`),
    in order inside one map task: each one's collect feeds the next's
    map, the last one's reaches the task's collector."""

    CONF_KEY = "tpumr.chain.mappers"

    @staticmethod
    def add_mapper(conf: Any, mapper_cls: type) -> None:
        conf.set(ChainMapper.CONF_KEY, list(conf.get(ChainMapper.CONF_KEY)
                                            or []) + [class_name(mapper_cls)])
        conf.set_mapper_class(ChainMapper)

    def configure(self, conf) -> None:
        names = conf.get(self.CONF_KEY) or []
        if not names:
            raise ValueError(f"{self.CONF_KEY} is empty — add_mapper first")
        self._chain = [new_instance(resolve_class(n), conf) for n in names]
        self._wired: "tuple[Any, OutputCollector] | None" = None

    def map(self, key, value, output, reporter):
        # wired once per output: collectors last as long as the task
        if self._wired is None or self._wired[0] is not output:
            self._wired = (output, _wire(self._chain[1:], output, reporter))
        self._chain[0].map(key, value, self._wired[1], reporter)

    def close(self) -> None:
        for m in self._chain:
            m.close()


class ChainReducer(Reducer):
    """The reducer of ``tpumr.chain.reducer`` (:meth:`set_reducer`), then
    the mappers of ``tpumr.chain.reduce.mappers`` over its output."""

    REDUCER_KEY = "tpumr.chain.reducer"
    MAPPERS_KEY = "tpumr.chain.reduce.mappers"

    @staticmethod
    def set_reducer(conf: Any, reducer_cls: type) -> None:
        conf.set(ChainReducer.REDUCER_KEY, class_name(reducer_cls))
        conf.set_reducer_class(ChainReducer)

    @staticmethod
    def add_mapper(conf: Any, mapper_cls: type) -> None:
        conf.set(ChainReducer.MAPPERS_KEY,
                 list(conf.get(ChainReducer.MAPPERS_KEY) or [])
                 + [class_name(mapper_cls)])

    def configure(self, conf) -> None:
        name = conf.get(self.REDUCER_KEY)
        if not name:
            raise ValueError(f"{self.REDUCER_KEY} unset — set_reducer first")
        self._reducer = new_instance(resolve_class(name), conf)
        self._mappers = [new_instance(resolve_class(n), conf)
                         for n in (conf.get(self.MAPPERS_KEY) or [])]
        self._wired: "tuple[Any, OutputCollector] | None" = None

    def reduce(self, key, values, output, reporter):
        if self._wired is None or self._wired[0] is not output:
            self._wired = (output, _wire(self._mappers, output, reporter))
        self._reducer.reduce(key, values, self._wired[1], reporter)

    def close(self) -> None:
        self._reducer.close()
        for m in self._mappers:
            m.close()


# ------------------------------------------------------- multiple inputs


def longest_prefix(table: "dict[str, Any]", path: str) -> Any:
    """The value of the longest key of ``table`` that is ``path`` or a
    directory above it ('in/users' does not claim 'in/users_extra/x'), or
    None."""
    best = None
    for prefix, value in table.items():
        if (path == prefix or path.startswith(prefix + "/")) and \
                (best is None or len(prefix) > len(best[0])):
            best = (prefix, value)
    return None if best is None else best[1]


class MultipleInputs:
    """A mapper class per input path (``tpumr.multiple.inputs``); the job's
    mapper becomes :class:`DelegatingMapper`. The input format stays the
    job's."""

    CONF_KEY = "tpumr.multiple.inputs"

    @staticmethod
    def add_input_path(conf: Any, path: str, mapper_cls: type) -> None:
        table = dict(conf.get(MultipleInputs.CONF_KEY) or {})
        table[str(path).rstrip("/")] = class_name(mapper_cls)
        conf.set(MultipleInputs.CONF_KEY, table)
        existing = conf.get_strings("mapred.input.dir")
        if str(path) not in existing:
            conf.set_input_paths(*(list(existing) + [str(path)]))
        conf.set_mapper_class(DelegatingMapper)


class DelegatingMapper(Mapper):
    """Hands each record to the mapper registered for the split's path
    (``tpumr.task.input.path``), built at the first record."""

    def configure(self, conf) -> None:
        self._conf = conf
        self._table = {p: resolve_class(n) for p, n in
                       (conf.get(MultipleInputs.CONF_KEY) or {}).items()}
        self._delegate: "Mapper | None" = None

    def _resolve(self) -> Mapper:
        if self._delegate is None:
            path = str(self._conf.get("tpumr.task.input.path") or "")
            cls = longest_prefix(self._table, path)
            if cls is None:
                raise ValueError(f"no mapper registered for split path "
                                 f"{path!r} (inputs: {sorted(self._table)})")
            self._delegate = new_instance(cls, self._conf)
        return self._delegate

    def map(self, key, value, output, reporter):
        self._resolve().map(key, value, output, reporter)

    def close(self) -> None:
        if self._delegate is not None:
            self._delegate.close()


# ------------------------------------------------------ multiple outputs


class MultipleOutputs:
    """Named side outputs beside the task's main output::

        mo = MultipleOutputs(conf)
        mo.collector("errors").collect(k, v)
        ...
        mo.close()

    Each name writes ``<name>-<partition>`` through the job's output format
    into the attempt's work dir (``tpumr.task.work.dir``), so side files
    are committed, or dropped, with the attempt."""

    def __init__(self, conf: Any) -> None:
        self._conf = conf
        self._writers: dict[str, Any] = {}

    def _work_dir(self) -> str:
        wd = self._conf.get("tpumr.task.work.dir")
        if not wd:
            raise ValueError("MultipleOutputs needs tpumr.task.work.dir "
                             "(set by the task runtime)")
        from tpumr_torch.fs.filesystem import FileSystem
        FileSystem.get(wd, self._conf).mkdirs(wd)   # made only when used
        return wd

    def collector(self, name: str, reporter: Any = None) -> OutputCollector:
        if not re.fullmatch(r"[A-Za-z0-9]+", name) or name == "part":
            raise ValueError(f"bad MultipleOutputs name {name!r} "
                             "(alphanumeric, not 'part' — that is the "
                             "main output's prefix)")
        w = self._writers.get(name)
        if w is None:
            out_fmt = new_instance(self._conf.get_output_format(),
                                   self._conf)
            # no partition stamped (use outside a task): number from 0
            part = max(0, self._conf.get_int("tpumr.task.partition", -1))
            w = self._writers[name] = out_fmt.get_record_writer(
                self._conf, self._work_dir(), part, prefix=name)
        return OutputCollector(w.write)

    def close(self) -> None:
        for w in self._writers.values():
            w.close()


# -------------------------------------------------------------- aggregate


class _Sum:
    def __init__(self, cast):
        self.cast, self.total = cast, cast(0)

    def add(self, v):
        self.total += self.cast(v)

    def result(self):
        return self.total


class _MinMax:
    def __init__(self, cast, is_max: bool):
        self.cast, self.is_max, self.cur = cast, is_max, None

    def add(self, v):
        v = self.cast(v)
        if self.cur is None or (v > self.cur if self.is_max else v < self.cur):
            self.cur = v

    def result(self):
        return self.cur


class _UniqCount:
    def __init__(self):
        self.seen: set = set()

    def add(self, v):
        self.seen.add(str(v))

    def result(self):
        return len(self.seen)


class _Histogram:
    def __init__(self):
        self.counts: Counter = Counter()

    def add(self, v):
        self.counts[str(v)] += 1

    def result(self):
        return ";".join(f"{k}:{n}" for k, n in sorted(self.counts.items()))


AGGREGATORS = {
    "LongValueSum": lambda: _Sum(int),
    "DoubleValueSum": lambda: _Sum(float),
    "LongValueMax": lambda: _MinMax(int, True),
    "LongValueMin": lambda: _MinMax(int, False),
    "StringValueMax": lambda: _MinMax(str, True),
    "StringValueMin": lambda: _MinMax(str, False),
    "UniqValueCount": lambda: _UniqCount(),
    "ValueHistogram": lambda: _Histogram(),
}


def _agg_for(key: str) -> "tuple[Any, str]":
    agg_type, sep, ident = str(key).partition(":")
    maker = AGGREGATORS.get(agg_type)
    if not sep or maker is None:
        raise ValueError(
            f"aggregate key {key!r} is not '<type>:<id>' with type in "
            f"{sorted(AGGREGATORS)}")
    return maker(), ident


class ValueAggregatorReducer(Reducer):
    """Folds each ``"<TYPE>:<id>"`` group with the named aggregator and
    emits (id, result)."""

    def reduce(self, key, values, output, reporter):
        agg, ident = _agg_for(key)
        for v in values:
            agg.add(v)
        output.collect(ident, agg.result())


class ValueAggregatorCombiner(Reducer):
    """The partial fold of the distributive aggregators, keeping the
    ``"<TYPE>:<id>"`` key; the others' values pass through."""

    DISTRIBUTIVE = {"LongValueSum", "DoubleValueSum", "LongValueMax",
                    "LongValueMin", "StringValueMax", "StringValueMin"}

    def reduce(self, key, values, output, reporter):
        if str(key).partition(":")[0] not in self.DISTRIBUTIVE:
            for v in values:   # uniq and histogram need every value
                output.collect(key, v)
            return
        agg, _ = _agg_for(key)
        for v in values:
            agg.add(v)
        output.collect(key, agg.result())
