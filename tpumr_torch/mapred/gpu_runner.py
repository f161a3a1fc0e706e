"""Device map runner: stages a whole split and runs the job's kernel mapper
on it.

Counterpart of ``tpumr/mapred/tpu_runner.py``:

- :class:`DeviceSplitCache` is ``HbmSplitCache`` (``:40-106``), keyed by
  torch device: a split staged once stays resident across the tasks and
  jobs of the process, so later rounds skip both the read and the copy;
- :func:`stage_batch` is ``stage_batch`` (``:322-390``): a dense split goes
  onto the device through the split cache, with the output chain's lookup
  (``device_output``) on a miss; any other split whose format has
  ``read_batch`` is read whole and stays on the host; otherwise the record
  reader is drained into a ``RecordBatch``;
- :meth:`GpuMapRunner.run` is ``TpuMapRunner.run`` (``:205-310``): a
  window's prefetched output is drained; else a kernel with the launch
  protocol is launched, fetched once and drained, and a host kernel's
  ``map_batch`` runs on the host batch. A kernel's device rows are offered
  to a dense output writer (``_offer_device_rows``, ``:401-440``);
- :func:`prelaunch_device_maps` is the window path (``:442-514``): it
  stages and launches a window of map tasks, then brings every task's
  output to the host in ONE copy, one synchronisation per window; it
  returns None for a job the window cannot take;
- :class:`CpuBatchMapRunner` is the CPU-slot runner (``:517-550``).

Faults (``:184-199``, ``:260-316``): before it stages, an accelerator
attempt passes the seams ``tpu.compile`` (classed ``compile``),
``tpu.execute`` and ``tpu.execute.d<id>`` (classed ``device``) of
``utils/fi``. An exception of the stage, or of the launch, the fetch and
the drain, is tagged with ``task.classify_accelerator_exception``: a CUDA
error of the card surfaces at the next call that synchronises with it,
which here is the device-to-host fetch of the task (or of the window), so
the fault is charged to the attempt and the card that fetched. Both
runners poll the attempt's kill flag at their batch boundaries.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tpumr_torch.core.counters import BackendCounter, TaskCounter
from tpumr_torch.device import select_device
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io.recordbatch import DenseBatch, RecordBatch
from tpumr_torch.io.writable import serialize
from tpumr_torch.mapred import device_output
from tpumr_torch.mapred.api import MapRunnable
from tpumr_torch.mapred.split import DenseSplit, InputSplit
from tpumr_torch.mapred.task import (FailureClass,
                                     classify_accelerator_exception,
                                     tag_failure)
from tpumr_torch.utils.fi import maybe_fail
from tpumr_torch.utils.reflection import new_instance


class DeviceSplitCache:
    """LRU cache of device-resident values, bounded by the bytes charged
    for them. Keyed by the split's identity (path, row range, dtype, file
    length and mtime) for staged splits, by (tag, device) for side
    inputs."""

    def __init__(self, capacity_bytes: int) -> None:
        self.capacity = capacity_bytes
        self._entries: "OrderedDict[tuple, tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> Any:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: tuple, value: Any, nbytes: int) -> None:
        with self._lock:
            if key in self._entries or nbytes > self.capacity:
                return  # oversized items never evict resident ones
            while self._bytes + nbytes > self.capacity and self._entries:
                _, (_old, old_bytes) = self._entries.popitem(last=False)
                self._bytes -= old_bytes
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def drop_where(self, pred) -> None:
        """Evict every entry whose key satisfies ``pred``."""
        with self._lock:
            for k in [k for k in self._entries if pred(k)]:
                _v, b = self._entries.pop(k)
                self._bytes -= b

    def snapshot(self) -> "list[tuple[tuple, int]]":
        """(key, charged bytes) of every entry, least recent first."""
        with self._lock:
            return [(k, b) for k, (_v, b) in self._entries.items()]

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes


_split_caches: dict[str, DeviceSplitCache] = {}
_cache_lock = threading.Lock()


def split_cache(device: torch.device, capacity_bytes: int) -> DeviceSplitCache:
    with _cache_lock:
        c = _split_caches.get(str(device))
        if c is None:
            c = _split_caches[str(device)] = DeviceSplitCache(capacity_bytes)
        c.capacity = capacity_bytes
        return c


def clear_split_caches() -> None:
    with _cache_lock:
        for c in _split_caches.values():
            c.clear()
        _split_caches.clear()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a (possibly read-only) host array onto ``device``. For the card
    the rows go through a pinned host buffer and an asynchronous copy.
    Dropping the buffer right after is safe: PyTorch's pinned-memory
    allocator does not hand a block out again until the copy enqueued
    from it has completed."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(arr))
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    host = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = arr
    return host.to(device, non_blocking=True)


def stage_batch(conf: Any, reader: Any, task: Any,
                device: "torch.device | None"
                ) -> "tuple[DenseBatch | RecordBatch, bool, int]":
    """The task's split as one batch. A format with ``read_batch`` hands the
    split over whole: a dense split, given a ``device``, as a tensor on it
    through the device split cache (a hit skips the read and the copy);
    any other split as a host batch. Otherwise the record ``reader`` is
    drained into a ``RecordBatch`` of the values (strings as UTF-8, other
    values serialized; keys dropped). Returns (batch, whether the reader
    counted the records, bytes staged): a host batch counts its ``nbytes``,
    as the JAX package counts them."""
    in_fmt = new_instance(conf.get_input_format(), conf)
    split = (InputSplit.from_dict(task.split)
             if task is not None and task.split else None)
    if split is not None and getattr(in_fmt, "read_batch", None) is not None:
        if device is not None and isinstance(split, DenseSplit):
            batch, staged = _stage_dense(conf, in_fmt, split, device)
            return batch, False, staged
        batch = in_fmt.read_batch(split, conf)
        return batch, False, batch.nbytes
    values = []
    for _k, v in reader:
        if isinstance(v, (bytes, bytearray)):
            values.append(bytes(v))
        elif isinstance(v, str):
            values.append(v.encode("utf-8"))
        else:
            values.append(serialize(v))
    batch = RecordBatch.from_values(values)
    return batch, True, batch.nbytes


def _stage_dense(conf: Any, in_fmt: Any, split: DenseSplit,
                 device: torch.device) -> tuple[DenseBatch, int]:
    """A dense split as a tensor on ``device``. Returns (batch, bytes
    actually copied to the device)."""
    if not conf.get_boolean("tpumr.tpu.split.cache", True):
        batch = in_fmt.read_batch(split, conf)
        return (DenseBatch(to_device(batch.values, device), batch.ids,
                           batch.meta), batch.nbytes)
    cache = split_cache(device,
                        conf.get_int("tpumr.tpu.split.cache.mb", 2048) << 20)
    # file freshness (length, mtime) is part of the key so a rewritten
    # input never serves stale resident data
    st = FileSystem.get(split.path, conf).get_status(split.path)
    key = (split.path, split.row_start, split.num_rows, split.dtype,
           split.data_offset, st.length, st.mtime)
    entry = cache.get(key)
    if entry is not None:
        staged, ids, meta = entry
        return DenseBatch(staged, ids, dict(meta)), 0
    # output chain: a predecessor job may have left this file's image on
    # the device; slice the split's rows there, with no read and no copy
    whole = device_output.lookup(conf, device,
                                 FileSystem.get(split.path, conf),
                                 split.path, st.length, st.mtime)
    if (whole is not None and whole.dim() == 2
            and whole.shape[0] >= split.row_start + split.num_rows
            and whole.shape[1] == split.cols
            and device_output.numpy_dtype(whole.dtype)
            == np.dtype(split.dtype)):
        staged = whole[split.row_start:split.row_start + split.num_rows]
        ids = np.arange(split.row_start, split.row_start + split.num_rows,
                        dtype=np.int64)
        cache.put(key, (staged, ids, {}),
                  staged.numel() * staged.element_size())
        return DenseBatch(staged, ids, {}), 0
    batch = in_fmt.read_batch(split, conf)
    staged = to_device(batch.values, device)
    nbytes = int(batch.values.nbytes)
    cache.put(key, (staged, batch.ids, dict(batch.meta)), nbytes)
    return DenseBatch(staged, batch.ids, batch.meta), nbytes


def _maybe_fail_accelerator(conf: Any, dev_id: int) -> None:
    """The accelerator seams, classed as the fault they stand for; the
    qualified ``tpu.execute.d<id>`` sickens one card while the others
    serve."""
    maybe_fail("tpu.compile", conf, failure_class=FailureClass.COMPILE)
    maybe_fail("tpu.execute", conf, failure_class=FailureClass.DEVICE)
    if dev_id >= 0:
        maybe_fail(f"tpu.execute.d{dev_id}", conf,
                   failure_class=FailureClass.DEVICE)


def job_kernel(conf: Any):
    """The job's kernel mapper. The job's mapper class is loaded first: a
    program that defines its kernel beside its mapper (``examples/sleep``)
    registers it on import, which a node runner in a process of its own
    has not done yet."""
    from tpumr_torch.ops import get_kernel
    name = conf.get_map_kernel()
    if not name:
        raise ValueError("task placed on the device but no kernel mapper "
                         "configured (JobConf.set_map_kernel)")
    conf.get_mapper_class()
    return get_kernel(name)


class GpuMapRunner(MapRunnable):
    """The accelerator slot's runner. On ``cuda`` a host kernel's maps run
    here too (``local_runner.maps_on_device``): they count as
    ``TPU_MAP_TASKS``, and their ``map_batch`` runs on the host batch."""

    def configure(self, conf: Any) -> None:
        self.conf = conf

    def run(self, reader, output, reporter, task_ctx=None) -> None:
        conf = self.conf
        dev_id = task_ctx.tpu_device_id if task_ctx is not None else -1
        _maybe_fail_accelerator(conf, dev_id)
        kernel = job_kernel(conf)
        reporter.raise_if_aborted()
        pre = task_ctx.device_prefetch if task_ctx is not None else None
        if pre is not None:
            # a window already staged, launched and fetched this task's
            # kernel output; only the drain remains
            if pre.device_rows is not None:
                device_output.offer(str(conf.get("tpumr.task.attempt.id")),
                                    pre.device_rows)
            reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                  TaskCounter.MAP_INPUT_RECORDS,
                                  pre.num_records)
            reporter.incr_counter(BackendCounter.GROUP,
                                  BackendCounter.TPU_DEVICE_BYTES_STAGED,
                                  pre.staged_bytes)
            for key, value in kernel.map_batch_drain(pre.fetched, conf,
                                                     task_ctx):
                output.collect(key, value)
            return
        device = select_device(conf, dev_id)
        try:
            batch, counted, staged_bytes = stage_batch(conf, reader,
                                                       task_ctx, device)
        except Exception as e:  # noqa: BLE001 — classified at the site
            raise tag_failure(e, classify_accelerator_exception(e))
        reporter.raise_if_aborted()
        if not counted:     # the record reader counts its own records
            reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                  TaskCounter.MAP_INPUT_RECORDS,
                                  batch.num_records)
        reporter.incr_counter(BackendCounter.GROUP,
                              BackendCounter.TPU_DEVICE_BYTES_STAGED,
                              staged_bytes)
        try:
            state = (kernel.map_batch_launch(batch, conf, task_ctx)
                     if type(kernel).supports_launch() else None)
            if state is not None:
                from tpumr_torch.ops.registry import fetch_to_host
                _offer_device_rows(kernel, state, conf)
                # the fetch synchronises: an asynchronous CUDA error of the
                # launch surfaces here, and is classified with it
                records = kernel.map_batch_drain(fetch_to_host([state])[0],
                                                 conf, task_ctx)
            else:
                records = kernel.map_batch(batch, conf, task_ctx)
            for key, value in records:
                output.collect(key, value)
        except Exception as e:  # noqa: BLE001 — classified at the site
            raise tag_failure(e, classify_accelerator_exception(e))


def _device_rows_of(kernel: Any, state: Any, conf: Any) -> Any:
    """The kernel's device output rows for the output chain, or None: only
    for a job whose output format claims them (``DenseNpyOutputFormat``),
    so no other job leaves tensors waiting for a claim."""
    hook = getattr(kernel, "device_output_rows", None)
    if hook is None or not getattr(conf.get_output_format(),
                                   "claims_device_rows", False):
        return None
    return hook(state)


def _offer_device_rows(kernel: Any, state: Any, conf: Any) -> None:
    rows = _device_rows_of(kernel, state, conf)
    if rows is not None:
        device_output.offer(str(conf.get("tpumr.task.attempt.id")), rows)


@dataclass
class DevicePrefetch:
    """Fetched kernel output of one map task of a window. ``device_rows``
    keeps the task's output tensor on the device, for the output chain,
    until the task offers it at its drain."""
    fetched: Any
    num_records: int
    staged_bytes: int
    device_rows: Any = None


def prelaunch_device_maps(conf: Any, tasks: "list[Any]"
                          ) -> "list[DevicePrefetch] | None":
    """Stage and launch a window of map tasks' kernels on one device, then
    fetch EVERY task's output in one device-to-host copy.

    Returns one :class:`DevicePrefetch` per task, possibly for a PREFIX of
    ``tasks`` only: the window's staged inputs stay on the device until the
    fetch, so the window closes once it has copied
    ``tpumr.tpu.pipeline.window.mb`` (always taking at least one task).
    Split-cache hits copy nothing and do not count. Returns None where the
    window cannot take the job, whose maps then run one by one, each
    through its runner: no kernel mapper (a pipes job), an accelerator
    runner other than :class:`GpuMapRunner`'s ``run`` (it would not read
    the prefetch), a kernel without the launch protocol (``wordcount``,
    ``grep``), an input format without ``read_batch`` (``pi``'s
    ``NLineInputFormat``), a task without a split, or tasks on more than
    one device."""
    from tpumr_torch.ops.registry import fetch_to_host
    if not conf.get_map_kernel():
        return None
    if conf.get_tpu_map_runner_class().run is not GpuMapRunner.run:
        return None
    kernel = job_kernel(conf)
    if not type(kernel).supports_launch():
        return None
    if getattr(new_instance(conf.get_input_format(), conf), "read_batch",
               None) is None:
        return None
    if any(not t.split for t in tasks):
        return None
    dev_ids = {t.tpu_device_id for t in tasks}
    if len(dev_ids) != 1:
        return None
    device = select_device(conf, dev_ids.pop())
    budget = conf.get_int("tpumr.tpu.pipeline.window.mb", 2048) << 20
    states: list[Any] = []
    meta: list[tuple[int, int, Any]] = []
    resident = 0
    for task in tasks:
        batch, _counted, staged_bytes = stage_batch(conf, None, task, device)
        state = kernel.map_batch_launch(batch, conf, task)
        if state is None:
            return None
        states.append(state)
        meta.append((batch.num_records, staged_bytes,
                     _device_rows_of(kernel, state, conf)))
        resident += staged_bytes
        if resident >= budget and len(states) < len(tasks):
            break  # close the window early; the caller resumes after us
    try:
        fetched = fetch_to_host(states)     # ONE copy for the window
    except Exception as e:  # noqa: BLE001 — the window's sync: classified
        raise tag_failure(e, classify_accelerator_exception(e))
    return [DevicePrefetch(f, n, b, rows)
            for f, (n, b, rows) in zip(fetched, meta)]


class CpuBatchMapRunner(MapRunnable):
    """CPU-slot runner: the whole split through the kernel's vectorized
    host twin (``map_batch_cpu``)."""

    def configure(self, conf: Any) -> None:
        self.conf = conf

    def run(self, reader, output, reporter, task_ctx=None) -> None:
        kernel = job_kernel(self.conf)
        batch, counted, _ = stage_batch(self.conf, reader, task_ctx, None)
        reporter.raise_if_aborted()
        if not counted:
            reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                  TaskCounter.MAP_INPUT_RECORDS,
                                  batch.num_records)
        reporter.incr_counter(BackendCounter.GROUP,
                              BackendCounter.CPU_BATCH_MAP_TASKS)
        for key, value in kernel.map_batch_cpu(batch, self.conf, task_ctx):
            output.collect(key, value)
