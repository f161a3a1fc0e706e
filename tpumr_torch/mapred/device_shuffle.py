"""The device-shuffled reduce: the shuffle's sort on the card.

Counterpart of ``tpumr/mapred/device_shuffle.py``. A job opts in with
``JobConf.set_device_shuffle(key_bytes, value_bytes)``: its map outputs are
fixed-width ``bytes`` keys and values, written by each map as one dense
file (``TDSH`` header, then the keys, then the values: no partitioning, no
sort, no spill). At submission the reduce phase becomes one gang task and
the job's reduce count becomes its number of output ranges
(:func:`prepare_device_shuffle_job`). The gang task
(:func:`run_device_reduce`) reads every map's dense file, sorts the keys on
the task's device (``parallel/device_sort.py``), cuts the sorted records
into the ranges of the job's partition file (or of cuts sampled from the
keys), and writes one part file per range through the job's output format,
through its reducer where it has one other than the identity.

The host memory is freed stage by stage, so that a 10 GB job holds about
one copy of its records: each map's file is released once its rows are in
the one records array, the key columns once they are on the device, and
the sorted rows are gathered and written a chunk at a time. A failure on
the device fails the attempt: there is no host sort to fall back to (the
JAX package sorts on the host only when its multi-device exchange
overflows, which one device never reaches).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Any, Callable

import numpy as np
import torch

from tpumr_torch.core.counters import BackendCounter, TaskCounter
from tpumr_torch.device import select_device
from tpumr_torch.mapred.api import (IdentityReducer, OutputCollector,
                                    RawComparator, Reporter)
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.task import Task
from tpumr_torch.parallel.device_sort import (_lex_gt, device_partition_sort,
                                              key_columns)
from tpumr_torch.utils.reflection import new_instance

DEVICE_SHUFFLE_KEY = "tpumr.shuffle.device"
KEY_BYTES_KEY = "tpumr.shuffle.device.key.bytes"
VALUE_BYTES_KEY = "tpumr.shuffle.device.value.bytes"
RANGES_KEY = "tpumr.shuffle.device.ranges"

_MAGIC = b"TDSH"
_HEADER = struct.Struct(">4sIHH")   # magic, n, klen, vlen

#: rows gathered and written at a time: a multiple of the SequenceFile
#: block, so chunked writes frame the blocks as one write would
GATHER_ROWS = 10_000_000


def is_device_shuffle(conf: Any) -> bool:
    return bool(conf.get_boolean(DEVICE_SHUFFLE_KEY, False))


def prepare_device_shuffle_job(conf: Any) -> None:
    """At submission: one gang reduce task; the reduce count the job asked
    for becomes its output range count. Refuses what the device sort
    cannot honour: no fixed widths, no reduce, a key order other than raw
    bytes, a grouping comparator."""
    if not is_device_shuffle(conf):
        return
    if conf.get_int(KEY_BYTES_KEY, 0) <= 0 or \
            conf.get_int(VALUE_BYTES_KEY, 0) < 0:
        raise ValueError(
            f"device shuffle needs fixed record widths: set {KEY_BYTES_KEY}"
            f" / {VALUE_BYTES_KEY} (JobConf.set_device_shuffle)")
    r = conf.num_reduce_tasks
    if r == 0:
        raise ValueError("device shuffle requires a reduce phase "
                         "(num_reduce_tasks >= 1)")
    cmp_cls = conf.get_class("mapred.output.key.comparator.class")
    if cmp_cls is not None and cmp_cls is not RawComparator:
        raise ValueError(
            f"device shuffle sorts raw bytes ascending; output key "
            f"comparator {cmp_cls.__name__} is not supported: use "
            f"RawComparator or the host shuffle")
    if conf.get_class("mapred.output.value.groupfn.class") is not None:
        raise ValueError("device shuffle does not support a grouping "
                         "comparator (secondary sort): use the host "
                         "shuffle")
    if not conf.get(RANGES_KEY):
        conf.set(RANGES_KEY, r)
    conf.set_num_reduce_tasks(1)


class DenseMapOutputBuffer:
    """A device-shuffled map's collector: fixed-width records appended to
    two byte buffers and written as one dense file."""

    def __init__(self, conf: Any, local_dir: str, reporter: Reporter) -> None:
        self.klen = conf.get_int(KEY_BYTES_KEY, 0)
        self.vlen = conf.get_int(VALUE_BYTES_KEY, 0)
        self.local_dir = local_dir
        self.reporter = reporter
        self._keys = bytearray()
        self._values = bytearray()
        self._n = 0
        os.makedirs(local_dir, exist_ok=True)

    def collect(self, key: Any, value: Any) -> None:
        if not isinstance(key, (bytes, bytearray)) or len(key) != self.klen:
            raise ValueError(
                f"device shuffle requires {self.klen}-byte keys, got "
                f"{type(key).__name__}"
                f"[{len(key) if hasattr(key, '__len__') else '?'}]")
        if not isinstance(value, (bytes, bytearray)) or \
                len(value) != self.vlen:
            raise ValueError(
                f"device shuffle requires {self.vlen}-byte values, got "
                f"{type(value).__name__}")
        self._keys += key
        self._values += value
        self._n += 1
        self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.MAP_OUTPUT_RECORDS)
        self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.MAP_OUTPUT_BYTES,
                                   self.klen + self.vlen)

    def collect_fixed_batch(self, keys: np.ndarray,
                            values: np.ndarray) -> None:
        """``[n, klen]`` and ``[n, vlen]`` uint8 rows at once, checked and
        counted as ``n`` calls of ``collect``."""
        if keys.ndim != 2 or keys.shape[1] != self.klen:
            raise ValueError(f"device shuffle requires {self.klen}-byte "
                             f"keys, got array {keys.shape}")
        if values.ndim != 2 or values.shape[1] != self.vlen:
            raise ValueError(f"device shuffle requires {self.vlen}-byte "
                             f"values, got array {values.shape}")
        if keys.shape[0] != values.shape[0]:
            raise ValueError("key/value row counts differ")
        n = int(keys.shape[0])
        self._keys += np.ascontiguousarray(keys, np.uint8).data
        self._values += np.ascontiguousarray(values, np.uint8).data
        self._n += n
        self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.MAP_OUTPUT_RECORDS, n)
        self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                   TaskCounter.MAP_OUTPUT_BYTES,
                                   n * (self.klen + self.vlen))

    def flush(self) -> tuple[str, dict]:
        path = os.path.join(self.local_dir, "file.dense")
        with open(path, "wb") as f:
            f.write(_HEADER.pack(_MAGIC, self._n, self.klen, self.vlen))
            f.write(self._keys)
            f.write(self._values)
        self._keys = bytearray()
        self._values = bytearray()
        return path, {"dense": True, "n": self._n,
                      "klen": self.klen, "vlen": self.vlen}


def parse_dense_bytes(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """``(keys [n, klen], values [n, vlen])`` uint8 views of a dense
    file's bytes."""
    magic, n, klen, vlen = _HEADER.unpack_from(data)
    if magic != _MAGIC:
        raise ValueError("not a dense map output (bad magic)")
    off = _HEADER.size
    keys = np.frombuffer(data, np.uint8, n * klen, off).reshape(n, klen)
    values = np.frombuffer(data, np.uint8, n * vlen,
                           off + n * klen).reshape(n, vlen)
    return keys, values


def read_dense_output(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        return parse_dense_bytes(f.read())


#: a dense fetch returns one map's (keys, values)
DenseFetchFn = Callable[[int], tuple[np.ndarray, np.ndarray]]


def _load_splitters(conf: Any, keys: np.ndarray, num_ranges: int,
                    klen: int) -> np.ndarray:
    """The range cut points ``[r - 1, klen]`` uint8: the job's partition
    file where it has one, else ``64 * r`` keys sampled evenly."""
    from tpumr_torch.fs.filesystem import FileSystem
    from tpumr_torch.io.writable import deserialize
    from tpumr_torch.mapred.total_order import PARTITION_PATH_KEY
    path = conf.get(PARTITION_PATH_KEY)
    if path:
        cuts = deserialize(FileSystem.get(path, conf).read_bytes(path))
        good = [c for c in cuts
                if isinstance(c, (bytes, bytearray)) and len(c) == klen]
        if len(good) == len(cuts) and cuts:
            return np.frombuffer(b"".join(good), np.uint8).reshape(-1, klen)
    if num_ranges <= 1 or keys.shape[0] == 0:
        return np.zeros((0, klen), np.uint8)
    n = keys.shape[0]
    sample_idx = np.linspace(0, n - 1, min(n, 64 * num_ranges)).astype(int)
    samp = keys[sample_idx]
    order = np.lexsort(tuple(samp[:, c] for c in range(klen - 1, -1, -1)))
    samp = samp[order]
    cut_idx = [min(len(samp) - 1, round(i * len(samp) / num_ranges))
               for i in range(1, num_ranges)]
    return samp[cut_idx]


def _range_boundaries(key_cols: Any, splitters: np.ndarray,
                      lo_range: int, hi_range: int) -> list[int]:
    """The boundary after each range of ``[lo_range, hi_range)`` in the
    sorted keys: the count of keys ``<= splitters[i]`` (a key equal to a
    cut stays low, as in ``compute_dest``). A count, so ``key_cols`` (numpy
    or torch key columns) may be in any order. A short cut list acts as
    +inf past its end: those ranges come back empty, as the host
    partitioner leaves them."""
    n = key_cols.shape[0]
    if n == 0:
        return [0] * (hi_range - lo_range - 1)
    scols = None
    if len(splitters):
        scols = key_columns(splitters, splitters.shape[1])
        if isinstance(key_cols, torch.Tensor):
            scols = torch.from_numpy(scols.astype(np.int64)).to(
                key_cols.device)
    bounds = []
    for i in range(lo_range, hi_range - 1):
        if scols is None or i >= len(scols):
            bounds.append(n)
        else:
            bounds.append(int(n - _lex_gt(key_cols, scols[i]).sum()))
    return bounds


def _gather(records: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``records[idx]`` by torch's threaded row gather on the host."""
    return torch.from_numpy(records).index_select(
        0, torch.from_numpy(idx)).numpy()


def run_device_reduce(conf: Any, task: Task, dense_fetch: DenseFetchFn,
                      reporter: "Reporter | None" = None) -> dict:
    """The gang reduce task: read every map's dense output, sort the keys
    on the task's device, write one part file per range into the attempt's
    work dir (the caller commits). Returns the seconds of each stage:
    ``fetch_s`` (reads and the one records array), ``key_columns_s``,
    ``upload_s``, ``argsort_s`` (and on ``cuda`` ``argsort_device_ms``),
    ``download_s``, ``boundaries_s``, ``gather_s`` and ``write_s``, with
    ``records``."""
    from tpumr_torch.mapred.map_task import localize_task_conf
    reporter = reporter or Reporter()
    conf = localize_task_conf(conf, task)
    device = select_device(conf, 0)
    klen = conf.get_int(KEY_BYTES_KEY, 0)
    vlen = conf.get_int(VALUE_BYTES_KEY, 0)
    num_ranges = conf.get_int(RANGES_KEY, 1)
    stages: dict[str, float] = {}

    t = time.monotonic()
    parts = []
    for m in range(task.num_maps):
        k, v = dense_fetch(m)
        if k.shape[1] != klen or v.shape[1] != vlen:
            raise ValueError(f"map {m} dense output widths "
                             f"({k.shape[1]},{v.shape[1]}) != conf "
                             f"({klen},{vlen})")
        parts.append((k, v))
    n = sum(k.shape[0] for k, _ in parts)
    records = np.empty((n, klen + vlen), np.uint8)
    lo = 0
    for m in range(len(parts)):
        k, v = parts[m]
        parts[m] = None   # the map's file buffer goes once its rows are in
        records[lo:lo + k.shape[0], :klen] = k
        records[lo:lo + k.shape[0], klen:] = v
        lo += k.shape[0]
        del k, v
    del parts
    stages["fetch_s"] = time.monotonic() - t
    reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                          TaskCounter.REDUCE_INPUT_RECORDS, n)
    splitters = _load_splitters(conf, records[:, :klen], num_ranges, klen)

    order = np.zeros(0, np.int64)
    cuts = [0] * num_ranges + [n]
    if n > 0:
        t = time.monotonic()
        kcols = key_columns(records, klen)
        stages["key_columns_s"] = time.monotonic() - t
        order, cols = device_partition_sort(kcols, device, stages)
        del kcols
        t = time.monotonic()
        cuts = [0] + _range_boundaries(cols, splitters, 0, num_ranges) + [n]
        del cols
        stages["boundaries_s"] = time.monotonic() - t
        reporter.incr_counter(BackendCounter.GROUP,
                              BackendCounter.TPU_SHUFFLE_RECORDS, n)
        reporter.incr_counter(BackendCounter.GROUP,
                              BackendCounter.TPU_SHUFFLE_BYTES,
                              int(records.nbytes))
        if device.type == "cuda":
            reporter.incr_counter(BackendCounter.GROUP,
                                  BackendCounter.DEVICE_SORT_ON_ACCEL)

    reducer_cls = conf.get_reducer_class()
    identity = reducer_cls is None or reducer_cls is IdentityReducer
    wd = FileOutputCommitter(conf).setup_task(str(task.attempt_id))
    out_fmt = new_instance(conf.get_output_format(), conf)
    stages["gather_s"] = stages["write_s"] = 0.0
    for r in range(num_ranges):
        writer = out_fmt.get_record_writer(conf, wd, r)
        ok = False
        try:
            if identity:
                for lo in range(cuts[r], cuts[r + 1], GATHER_ROWS):
                    t = time.monotonic()
                    rows = _gather(records,
                                   order[lo:min(lo + GATHER_ROWS,
                                                cuts[r + 1])])
                    stages["gather_s"] += time.monotonic() - t
                    t = time.monotonic()
                    _write_rows(writer, rows, klen, reporter)
                    stages["write_s"] += time.monotonic() - t
            else:
                rows = _gather(records, order[cuts[r]:cuts[r + 1]])
                _reduce_rows(conf, reducer_cls, rows, klen, writer, reporter)
            ok = True
        finally:
            abort = None if ok else getattr(writer, "abort", None)
            (abort or writer.close)()
    stages["records"] = n
    return stages


def _write_rows(writer: Any, rows: np.ndarray, klen: int,
                reporter: Reporter) -> None:
    bulk = getattr(writer, "write_fixed_rows", None)
    if bulk is not None:
        bulk(rows, klen)
    else:
        for i in range(rows.shape[0]):
            writer.write(rows[i, :klen].tobytes(), rows[i, klen:].tobytes())
    reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                          TaskCounter.REDUCE_OUTPUT_RECORDS, rows.shape[0])


def _reduce_rows(conf: Any, reducer_cls: type, rows: np.ndarray, klen: int,
                 writer: Any, reporter: Reporter) -> None:
    """The job's reducer over one range's sorted rows, a group per run of
    equal keys."""
    reducer = new_instance(reducer_cls, conf)
    n = rows.shape[0]

    def emit(k: Any, v: Any) -> None:
        reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                              TaskCounter.REDUCE_OUTPUT_RECORDS)
        writer.write(k, v)

    collector = OutputCollector(emit)
    ok = False
    try:
        i = 0
        while i < n:
            key = rows[i, :klen].tobytes()
            j = i
            while j < n and rows[j, :klen].tobytes() == key:
                j += 1
            reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                  TaskCounter.REDUCE_INPUT_GROUPS)
            values = (rows[t, klen:].tobytes() for t in range(i, j))
            reducer.reduce(key, values, collector, reporter)
            i = j
        ok = True
    finally:
        abort = None if ok else getattr(reducer, "abort", None)
        (abort or reducer.close)()


def local_dense_fetch(map_outputs: "list[tuple[str, dict]]"
                      ) -> DenseFetchFn:
    """In-process fetch of the maps' dense files (the local runner)."""

    def fetch(map_index: int) -> tuple[np.ndarray, np.ndarray]:
        return read_dense_output(map_outputs[map_index][0])

    return fetch
