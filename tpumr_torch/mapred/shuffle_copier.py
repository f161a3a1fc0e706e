"""The shuffle's copy phase: parallel, chunked, within a RAM budget, and
surviving the loss of a map's output.

Counterpart of ``tpumr/mapred/shuffle_copier.py``:

- :class:`ShuffleCopier` (``:608-1225``): ``tpumr.shuffle.parallel.copies``
  fetcher threads pull every map's segment of the reduce's partition in
  bounded chunks; a :class:`ShuffleRamManager` (``:89-146``) decides by a
  segment's raw (decompressed) size whether it lands in memory
  (:class:`MemorySegment`) or streams to a local file
  (:class:`DiskSegment`), so the reduce holds at most the budget plus a
  chunk per fetcher; a budget-starved fetcher waits at most
  ``tpumr.shuffle.merge.reserve.wait.ms`` for the merger to free room,
  then goes to disk;
- :class:`ShuffleMergeManager` (``:296-606``): a background thread merges
  the memory segments, through the job's combiner where it has one, into a
  sorted run on disk once they fill ``mapred.job.shuffle.merge.percent`` of
  the budget, releasing their reservations during the copy; a second one
  folds every ``io.sort.factor`` disk segments into one run;
- the lost-output protocol: a failed fetch goes back in the queue. Each
  serving address has a :class:`PenaltyBox` (``:250-294``: a capped,
  jittered, doubling hold-off); after
  ``tpumr.shuffle.fetch.retries.per.source`` failures against one address
  the copier reports the map's attempt through ``on_fetch_failure``, where
  it has one (the master re-executes the map), and invalidates the cached
  address, so that the re-run's address is picked up while the copy goes
  on. ``tpumr.shuffle.fetch.max.failures`` failures of one map end the
  attempt;
- :class:`RemoteChunkSource` (``:1228-1375``): ``get_map_output_chunk``
  calls to the runner that serves each map, found through a
  ``tasktracker.MapLocator`` over the master's completion events, with the
  wire codec undone on arrival (``io/compress.wire_compress``);
- :class:`LocalSegmentSource` (``:231-247``): lazy views over the map
  outputs' files in this process, for the local runner.

Left out (``ROADMAP.md`` §1): the batched fetch (``_coalesce``,
``_copy_batch``, ``_land_batch_entry``), pipelined chunk calls
(``fetch_chunks``' ``call_begin``/``call_finish`` window: the port's
``fetch_chunks`` asks for one chunk at a time), size-aware fetch order,
the ``shuffle`` metrics histograms and the tracing spans, the in-line
retries of a copier with no report callback (``_copy_with_retries``,
``tpumr.shuffle.copy.retries``: the penalty box is the port's one retry
loop) and ``tpumr.shuffle.merge.enabled`` (the merger runs wherever there
is a budget and more than one map). The port's
Reporter has no progress or liveness calls; a killed attempt stops the
copy through the source's ``abort_check``.
"""

from __future__ import annotations

import os
import queue
import random
import tempfile
import threading
import time
from typing import Any, Callable, Iterable, Iterator

from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.io import ifile
from tpumr_torch.io.compress import get_codec, wire_codec_or_none
from tpumr_torch.mapred.api import TaskKilledError

#: a chunk source: ``fetch(map_index, partition, offset)`` returns a dict
#: with ``data`` (payload bytes from ``offset``), ``total`` (the payload's
#: length), ``raw`` (the decompressed segment's length) and ``codec``
ChunkFetch = Callable[[int, int, int], dict]

#: defaults of the keys read here, the JAX package's (its confkeys registry)
_DEFAULTS = {
    "tpumr.shuffle.parallel.copies": 5,
    "tpumr.shuffle.ram.mb": 128.0,
    "mapred.job.shuffle.input.buffer.percent": 0.7,
    "mapred.job.shuffle.merge.percent": 0.66,
    "tpumr.shuffle.merge.reserve.wait.ms": 2000.0,
    "tpumr.shuffle.copy.backoff.ms": 200.0,
    "tpumr.shuffle.copy.backoff.max.ms": 10000.0,
    "tpumr.shuffle.fetch.retries.per.source": 3,
    "tpumr.shuffle.fetch.max.failures": 50,
    "tpumr.shuffle.chunk.bytes": 1 << 20,
    "tpumr.shuffle.wire.codec": "tlz",
    "io.sort.factor": 10,
}


def _int(conf: Any, key: str) -> int:
    return conf.get_int(key, _DEFAULTS[key])


def _float(conf: Any, key: str) -> float:
    return conf.get_float(key, _DEFAULTS[key])


class ShuffleRamManager:
    """The in-memory shuffle budget, in raw segment bytes. One segment may
    claim at most ``max_single_frac`` of the whole."""

    def __init__(self, budget_bytes: int,
                 max_single_frac: float = 0.25) -> None:
        self.budget = max(0, int(budget_bytes))
        self.max_single = int(self.budget * max_single_frac)
        self._used = 0
        self._lock = threading.Lock()
        self._freed = threading.Condition(self._lock)

    @property
    def used(self) -> int:
        return self._used

    def try_reserve(self, nbytes: int) -> bool:
        """Claim budget for one segment, or refuse; never blocks."""
        if nbytes > self.max_single:
            return False
        with self._lock:
            if self._used + nbytes > self.budget:
                return False
            self._used += nbytes
            return True

    def reserve_wait(self, nbytes: int, keep_waiting: "Callable[[], bool]",
                     timeout_s: float) -> bool:
        """Wait for budget while ``keep_waiting()`` says a merge may still
        free some, for at most ``timeout_s``; False sends the caller to
        disk. The bound keeps a stalled merger from stalling the copy."""
        if nbytes > self.max_single:
            return False
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._freed:
            while True:
                if self._used + nbytes <= self.budget:
                    self._used += nbytes
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not keep_waiting():
                    return False
                # short waits: keep_waiting() may turn false with no release
                self._freed.wait(min(remaining, 0.05))

    def release(self, nbytes: int) -> None:
        with self._freed:
            self._used = max(0, self._used - nbytes)
            self._freed.notify_all()


class Segment:
    """One map output's partition segment, iterable as (kbytes, vbytes)."""

    #: raw (decompressed) bytes, which the merge's pass windows weigh
    raw_length = 0
    #: bytes that crossed the wire for it (0 for a local segment)
    wire_length = 0

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySegment(Segment):
    """A decompressed segment held under a reservation of ``reserved``
    bytes (the raw size the index announced), released exactly once."""

    def __init__(self, raw: bytes, ram: "ShuffleRamManager | None",
                 reserved: "int | None" = None) -> None:
        self._raw: "bytes | None" = raw
        self.raw_length = len(raw)
        self._reserved = self.raw_length if reserved is None else reserved
        self._ram = ram

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        if self._raw is None:
            raise ValueError("segment closed")
        return ifile.iter_segment(self._raw)

    def close(self) -> None:
        if self._raw is not None and self._ram is not None:
            self._ram.release(self._reserved)
        self._raw = None


class DiskSegment(Segment):
    """A segment's payload in a region of a local file, its records
    streamed out in chunks through the codec's decompressor when the merge
    reads them. ``owns_file``: ``close`` deletes the file (a fetched
    segment's spill); a view over a map's own file leaves it."""

    def __init__(self, path: str, codec: str, raw_length: int,
                 offset: int = 0, length: "int | None" = None,
                 owns_file: bool = True) -> None:
        self.path = path
        self.codec = codec
        self.raw_length = raw_length
        self.offset = offset
        self.length = (length if length is not None
                       else os.path.getsize(path) - offset)
        self._owns = owns_file

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        return ifile.iter_chunked_segment(
            ifile.file_region_chunks(self.path, self.offset, self.length),
            self.codec)

    def close(self) -> None:
        if self._owns:
            try:
                os.unlink(self.path)
            except OSError:
                pass


def spill_region_segment(path: str, index: dict,
                         partition: int) -> DiskSegment:
    """A segment over one partition of an existing spill file, which stays
    its writer's."""
    off, raw_len, part_len = index["partitions"][partition]
    # past the 4-byte length: the payload is part_len - 4 bytes
    return DiskSegment(path, index.get("codec", "none"), raw_len,
                       offset=off + 4, length=part_len - 4, owns_file=False)


class LocalSegmentSource:
    """``segments(partition)`` over the (path, index) outputs of the maps
    of this process, in map order; a map with no file (``""``) has no
    segment."""

    def __init__(self, map_outputs: "list[tuple[str, dict]]") -> None:
        self._outputs = map_outputs

    def segments(self, partition: int) -> "list[Segment]":
        return [spill_region_segment(path, index, partition)
                for path, index in self._outputs if path]


class PenaltyBox:
    """Per-source hold-offs: each failure against a source doubles its
    hold-off up to ``cap_s``, jittered to 50-100% of nominal so that
    fetchers never return to a recovering runner in step; a success clears
    the source. Stamps are on the monotonic clock."""

    def __init__(self, base_s: float, cap_s: float) -> None:
        self.base_s = max(0.0, base_s)
        self.cap_s = max(self.base_s, cap_s)
        self._lock = threading.Lock()
        self._strikes: dict[str, int] = {}
        self._until: dict[str, float] = {}

    def punish(self, key: str) -> float:
        """Record one failure; returns the hold-off in seconds."""
        with self._lock:
            strikes = self._strikes.get(key, 0) + 1
            self._strikes[key] = strikes
            delay = min(self.cap_s, self.base_s * (2 ** (strikes - 1)))
            delay *= 0.5 + random.random() * 0.5
            self._until[key] = max(self._until.get(key, 0.0),
                                   time.monotonic() + delay)
            return delay

    def until(self, key: str) -> float:
        """When (monotonic clock) the source may be fetched from again."""
        with self._lock:
            return self._until.get(key, 0.0)

    def clear(self, key: str) -> None:
        with self._lock:
            self._strikes.pop(key, None)
            self._until.pop(key, None)

    def active(self) -> int:
        """Sources serving a hold-off now."""
        now = time.monotonic()
        with self._lock:
            return sum(1 for t in self._until.values() if t > now)


class ShuffleMergeManager:
    """The background merges of the copy phase. Fetchers hand it each
    landed :class:`MemorySegment` (:meth:`offer`); once they fill
    ``mapred.job.shuffle.merge.percent`` of the budget, or a budget-starved
    fetcher asks (:meth:`request_merge`), its thread merges them, through
    the job's combiner where it has one, into one sorted run on disk
    (``io/merger.write_run``) and closes them, which releases their
    reservations. A second thread folds every ``io.sort.factor`` landed
    disk segments (:meth:`offer_disk`) into one run. Batches merge in map
    order, so equal keys keep the order of a flat merge."""

    def __init__(self, conf: Any, ram: ShuffleRamManager, spill_dir: str,
                 reporter: Any) -> None:
        self.conf = conf
        self.ram = ram
        self.spill_dir = spill_dir
        self.reporter = reporter
        pct = _float(conf, "mapred.job.shuffle.merge.percent")
        self.threshold = max(1, int(ram.budget * pct))
        get_cmp = getattr(conf, "get_output_key_comparator", None)
        self._sort_key = (get_cmp().sort_key if get_cmp is not None
                          else None)
        get_comb = getattr(conf, "get_combiner_class", None)
        self.combiner_cls = get_comb() if get_comb is not None else None
        self.codec = getattr(conf, "compress_map_output", "none")
        self._cond = threading.Condition()
        self._pending: "list[tuple[int, MemorySegment]]" = []
        self._pending_bytes = 0
        self._merged_ids: "set[int]" = set()
        self._runs: "list[Any]" = []
        self._requested = False
        self._busy = False
        self._closed = False
        self._error: "Exception | None" = None
        self._thread: "threading.Thread | None" = None
        self.inmem_merges = 0
        self.inmem_merge_segments = 0
        self.disk_factor = max(2, _int(conf, "io.sort.factor"))
        self._pending_disk: "list[tuple[int, Segment]]" = []
        self._disk_thread: "threading.Thread | None" = None
        self.disk_merges = 0
        self.disk_merge_segments = 0

    # ------------------------------------------------------- fetcher side

    def offer(self, map_index: int, seg: MemorySegment) -> bool:
        """Take a landed memory segment. False (the caller keeps it) once
        the manager is closed or its merger died."""
        with self._cond:
            if self._closed or self._error is not None:
                return False
            self._pending.append((map_index, seg))
            self._pending_bytes += seg.raw_length
            if self._pending_bytes >= self.threshold \
                    and len(self._pending) >= 2:
                self._requested = True
                self._cond.notify_all()
            self._ensure_thread()
            return True

    def offer_disk(self, map_index: int, seg: Segment) -> bool:
        """Take a landed disk segment; ``io.sort.factor`` of them are
        folded into one run. False once closed or failed."""
        with self._cond:
            if self._closed or self._error is not None:
                return False
            self._pending_disk.append((map_index, seg))
            if len(self._pending_disk) >= self.disk_factor:
                self._ensure_disk_thread()
                self._cond.notify_all()
            return True

    def request_merge(self) -> None:
        """A budget-starved fetcher asks for what has gathered to be
        merged out of memory now, below the threshold."""
        with self._cond:
            if self._closed or self._error is not None \
                    or len(self._pending) < 2:
                return
            self._requested = True
            self._ensure_thread()
            self._cond.notify_all()

    def busy_or_pending(self) -> bool:
        """May budget be freed soon? (a waiting fetcher's predicate). A
        stored merge error means never: the fetcher goes to disk at once."""
        with self._cond:
            return self._error is None and (self._busy or self._requested)

    # ------------------------------------------------------- merger side

    def _ensure_thread(self) -> None:
        # started lazily, under _cond: a copier that never lands a memory
        # segment starts no thread
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="shuffle-inmem-merger",
                                            daemon=True)
            self._thread.start()

    def _ensure_disk_thread(self) -> None:
        # a thread of its own: a long disk merge must not hold up the
        # merges that free budget
        if self._disk_thread is None:
            self._disk_thread = threading.Thread(
                target=self._disk_loop, name="shuffle-disk-merger",
                daemon=True)
            self._disk_thread.start()

    def _disk_loop(self) -> None:
        while True:
            with self._cond:
                while (not self._closed and
                       len(self._pending_disk) < self.disk_factor):
                    self._cond.wait(0.1)
                if self._closed:
                    return
                self._pending_disk.sort(key=lambda p: p[0])
                batch = [s for _, s in self._pending_disk[:self.disk_factor]]
                del self._pending_disk[:self.disk_factor]
            try:
                self._merge_disk_batch(batch)
            except Exception as e:  # noqa: BLE001 — raised at finish()
                for seg in batch:
                    seg.close()
                with self._cond:
                    self._error = e
                    self._merged_ids.update(id(s) for s in batch)
                    self._cond.notify_all()
                return

    def _merge_disk_batch(self, batch: "list[Segment]") -> None:
        from tpumr_torch.io import merger
        if sum(s.raw_length for s in batch) <= 2 * self.ram.budget:
            # a factor of budget-sized spills: held for a moment (bounded
            # by construction, not reserved) for the faster merge
            run = merger.write_run(
                ifile.merge_sorted_inmem(batch, self._sort_key),
                self.spill_dir, prefix="disk-merge")
        else:
            run = merger.write_run_streaming(
                ifile.merge_sorted(batch, self._sort_key), self.spill_dir,
                prefix="disk-merge")
        for seg in batch:
            seg.close()
        with self._cond:
            self._runs.append(run)
            self._merged_ids.update(id(s) for s in batch)
            self.disk_merges += 1
            self.disk_merge_segments += len(batch)
        self._count(TaskCounter.SHUFFLE_DISK_MERGES,
                    TaskCounter.SHUFFLE_DISK_MERGE_SEGMENTS, len(batch))

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not self._requested:
                    self._cond.wait(0.1)
                if self._requested and len(self._pending) >= 2:
                    batch = [s for _, s in sorted(self._pending,
                                                  key=lambda p: p[0])]
                    self._pending = []
                    self._pending_bytes = 0
                    self._requested = False
                    self._busy = True
                elif self._closed:
                    return
                else:
                    self._requested = False
                    continue
            try:
                self._merge_batch(batch)
            except Exception as e:  # noqa: BLE001 — raised at finish()
                for seg in batch:
                    seg.close()   # the reservations go back regardless
                with self._cond:
                    self._error = e
                    self._busy = False
                    self._merged_ids.update(id(s) for s in batch)
                    self._cond.notify_all()
                return
            with self._cond:
                self._busy = False
                self._cond.notify_all()

    def _merge_batch(self, batch: "list[MemorySegment]") -> None:
        from tpumr_torch.io import merger
        merged: "Iterable[tuple[bytes, bytes]]" = \
            ifile.merge_sorted_inmem(batch, self._sort_key)
        if self.combiner_cls is not None:
            from tpumr_torch.mapred.combine import combined_stream
            merged = combined_stream(self.conf, self.combiner_cls,
                                     self._sort_key, merged, self.reporter)
        run = merger.write_run(merged, self.spill_dir, codec=self.codec,
                               prefix="inmem-merge")
        for seg in batch:
            seg.close()   # the budget frees here, during the copy
        with self._cond:
            self._runs.append(run)
            self._merged_ids.update(id(s) for s in batch)
            self.inmem_merges += 1
            self.inmem_merge_segments += len(batch)
        self._count(TaskCounter.SHUFFLE_INMEM_MERGES,
                    TaskCounter.SHUFFLE_INMEM_MERGE_SEGMENTS, len(batch))

    def _count(self, merges: str, segments: str, n: int) -> None:
        if self.reporter is not None:
            self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                       merges, 1)
            self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                       segments, n)

    # ---------------------------------------------------------- lifecycle

    def finish(self) -> "list[Any]":
        """Stop the merge threads (a requested merge still runs) and
        return the runs; raise a stored merge error."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            threads = [t for t in (self._thread, self._disk_thread)
                       if t is not None]
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        # disk segments left unmerged stay out of _merged_ids: the copier
        # returns them as ordinary segments
        return list(self._runs)

    @property
    def merged_ids(self) -> "set[int]":
        with self._cond:
            return set(self._merged_ids)

    def abort(self) -> None:
        """On failure: close the pending segments (releasing budget) and
        delete the runs."""
        with self._cond:
            self._closed = True
            self._requested = False
            self._cond.notify_all()
            threads = [t for t in (self._thread, self._disk_thread)
                       if t is not None]
        for t in threads:
            t.join(timeout=30)
        with self._cond:
            pending, self._pending = self._pending, []
            pending_disk, self._pending_disk = self._pending_disk, []
            self._pending_bytes = 0
            runs, self._runs = self._runs, []
        for _, seg in pending + pending_disk:
            seg.close()
        for run in runs:
            run.close()


class ShuffleCopier:
    """The copy phase: ``copy_all()`` returns every map's segment of this
    reduce's partition (merged runs first, then the rest in map order),
    fetched by a pool of fetcher threads from ``source``."""

    def __init__(self, conf: Any, source: ChunkFetch, num_maps: int,
                 partition: int, spill_dir: str, reporter: Any = None,
                 on_fetch_failure: "Callable[[int, str], None] | None"
                 = None,
                 abort_check: "Callable[[], bool] | None" = None) -> None:
        self.conf = conf
        self.source = source
        self.num_maps = num_maps
        self.partition = partition
        self.spill_dir = spill_dir
        self.reporter = reporter
        #: ``on_fetch_failure(map_index, map_attempt_id)``, called after
        #: ``retries.per.source`` failures against one address; None: no
        #: report, and a fetch that keeps failing ends the attempt at
        #: ``fetch.max.failures`` as with one
        self.on_fetch_failure = on_fetch_failure
        self._abort_check = abort_check or (lambda: False)
        self.parallel = max(1, _int(conf, "tpumr.shuffle.parallel.copies"))
        ram_mb = _float(conf, "tpumr.shuffle.ram.mb")
        pct = _float(conf, "mapred.job.shuffle.input.buffer.percent")
        self.ram = ShuffleRamManager(int(ram_mb * 1024 * 1024 * pct))
        self.backoff_s = _float(conf, "tpumr.shuffle.copy.backoff.ms") / 1e3
        self.backoff_cap_s = _float(
            conf, "tpumr.shuffle.copy.backoff.max.ms") / 1e3
        self.retries_per_source = max(1, _int(
            conf, "tpumr.shuffle.fetch.retries.per.source"))
        #: failures of one map after which the attempt gives up: bounds a
        #: copy against a map never re-run
        self.max_fetch_failures = max(1, _int(
            conf, "tpumr.shuffle.fetch.max.failures"))
        self.penalty_box = PenaltyBox(self.backoff_s, self.backoff_cap_s)
        #: where segments landed, and the failures met (guarded by
        #: _stats_lock: the fetchers update them)
        self.spilled_to_disk = 0
        self.copied_in_memory = 0
        self.fetch_failures = 0
        self.fetch_failures_reported = 0
        self._stats_lock = threading.Lock()
        self._map_failures: dict[int, int] = {}
        self._src_failures: dict[tuple[int, str], int] = {}
        self.merger: "ShuffleMergeManager | None" = None
        if self.ram.budget > 0 and num_maps >= 2:
            self.merger = ShuffleMergeManager(conf, self.ram, spill_dir,
                                              reporter)
        self.reserve_wait_s = _float(
            conf, "tpumr.shuffle.merge.reserve.wait.ms") / 1e3

    # ------------------------------------------------------------ one map

    def _copy_one(self, map_index: int) -> Segment:
        from tpumr_torch.utils.fi import maybe_fail
        maybe_fail("shuffle.fetch", self.conf)
        maybe_fail(f"shuffle.fetch.m{map_index}", self.conf)
        first = self.source(map_index, self.partition, 0)

        def rest() -> "Iterator[dict]":
            got = len(first["data"])
            total = int(first["total"])
            while got < total:
                nxt = self.source(map_index, self.partition, got)
                if not nxt["data"]:
                    raise EOFError(f"shuffle source returned an empty chunk "
                                   f"at {got}/{total} for map {map_index}")
                yield nxt
                got += len(nxt["data"])

        return self._materialize(map_index, first, rest())

    def _materialize(self, map_index: int, first: dict,
                     rest: "Iterator[dict]") -> Segment:
        """Land one segment from its first chunk and the rest: reserve
        budget (waiting a bounded time for the merger) or go to disk,
        count wire against raw bytes, and check the byte count."""
        total = int(first["total"])
        raw = int(first.get("raw", total))
        codec = first.get("codec", "none")
        parts = [first["data"]]
        got = len(first["data"])
        wire = int(first.get("wire_len", got))

        reserved = self.ram.try_reserve(raw)
        if not reserved and self.merger is not None:
            # budget full: have the merger move the memory segments to a
            # run, and wait a bounded time for the room it frees
            self.merger.request_merge()
            reserved = self.ram.reserve_wait(
                raw, self.merger.busy_or_pending, self.reserve_wait_s)
        if reserved:
            try:
                for nxt in rest:
                    parts.append(nxt["data"])
                    got += len(nxt["data"])
                    wire += int(nxt.get("wire_len", len(nxt["data"])))
                if got != total:
                    raise EOFError(f"shuffle stream ended at {got}/{total} "
                                   f"for map {map_index}")
                raw_bytes = get_codec(codec).decompress(b"".join(parts))
                with self._stats_lock:
                    self.copied_in_memory += 1
                seg: Segment = MemorySegment(raw_bytes, self.ram,
                                             reserved=raw)
            except BaseException:
                self.ram.release(raw)
                raise
        else:
            # to disk: the chunks stream straight into a local spill
            fd, path = tempfile.mkstemp(prefix=f"shuffle-m{map_index}-",
                                        suffix=".seg", dir=self.spill_dir)
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(parts[0])
                    for nxt in rest:
                        f.write(nxt["data"])
                        got += len(nxt["data"])
                        wire += int(nxt.get("wire_len", len(nxt["data"])))
                if got != total:
                    raise EOFError(f"shuffle stream ended at {got}/{total} "
                                   f"for map {map_index}")
            except BaseException:
                try:
                    os.unlink(path)
                except OSError:
                    pass
                raise
            with self._stats_lock:
                self.spilled_to_disk += 1
            seg = DiskSegment(path, codec, raw)
        seg.wire_length = wire
        return seg

    # ------------------------------------------- the lost-output protocol

    def _source_hook(self, name: str, map_index: int, default: Any = None):
        fn = getattr(self.source, name, None)
        if fn is None:
            return default
        try:
            return fn(map_index)
        except Exception:  # noqa: BLE001 — the hooks are advisory
            return default

    def _addr_of(self, map_index: int) -> str:
        """The map's serving address as last resolved (the penalty box's
        key), or a key of the map's own where the source has none."""
        return self._source_hook("addr_of", map_index) or f"map-{map_index}"

    def _penalized_until(self, map_index: int) -> float:
        return self.penalty_box.until(self._addr_of(map_index))

    def _note_success(self, map_index: int) -> None:
        self.penalty_box.clear(self._addr_of(map_index))
        with self._stats_lock:
            self._map_failures.pop(map_index, None)
            # the source's strikes too, or blips far apart would add up to
            # a report against a healthy source
            for k in [k for k in self._src_failures if k[0] == map_index]:
                del self._src_failures[k]

    def _note_failure(self, map_index: int) -> "float | None":
        """Count one failed fetch. Returns the retry hold-off, or None
        where the failure is final (the map's ceiling)."""
        addr = self._addr_of(map_index)
        with self._stats_lock:
            total = self._map_failures.get(map_index, 0) + 1
            self._map_failures[map_index] = total
            key = (map_index, addr)
            per_src = self._src_failures.get(key, 0) + 1
            self._src_failures[key] = per_src
            self.fetch_failures += 1
        if total >= self.max_fetch_failures:
            return None
        delay = self.penalty_box.punish(addr)
        if self.reporter is not None:
            self.reporter.incr_counter(TaskCounter.FRAMEWORK_GROUP,
                                       TaskCounter.REDUCE_FETCH_FAILURES, 1)
        if per_src % self.retries_per_source == 0:
            # this address had its chances: report the map's attempt (the
            # master counts reducers and re-executes the map) and drop the
            # cached address, so the next round resolves it again
            attempt = self._source_hook("attempt_of", map_index, "") or ""
            try:
                if self.on_fetch_failure is not None:
                    self.on_fetch_failure(map_index, attempt)
                    with self._stats_lock:
                        self.fetch_failures_reported += 1
            except Exception:  # noqa: BLE001 — a report is best-effort;
                pass           # the penalty loop keeps the reduce going
            self._source_hook("invalidate", map_index)
        return delay

    # ------------------------------------------------------------ the phase

    def copy_all(self) -> "list[Segment]":
        os.makedirs(self.spill_dir, exist_ok=True)
        results: "list[Segment | None]" = [None] * self.num_maps
        errors: "list[BaseException]" = []
        #: (ready at, map index): a failed map goes back in with a hold-off
        #: instead of failing the reduce; the queue drains only when every
        #: map is copied
        work: "queue.PriorityQueue[tuple[float, int]]" = queue.PriorityQueue()
        for m in range(self.num_maps):
            work.put((0.0, m))
        outstanding = [self.num_maps]
        lock = threading.Lock()

        def land(m: int, seg: Segment) -> None:
            self._note_success(m)
            if self.merger is not None and isinstance(seg, MemorySegment):
                # the merger owns it now; results[m] keeps a handle for the
                # error path's sweep (closing twice is safe)
                self.merger.offer(m, seg)
            elif self.merger is not None and isinstance(seg, DiskSegment):
                self.merger.offer_disk(m, seg)
            with lock:
                results[m] = seg
                outstanding[0] -= 1
            if self.reporter is not None:
                self.reporter.incr_counter(
                    TaskCounter.FRAMEWORK_GROUP,
                    TaskCounter.REDUCE_SHUFFLE_BYTES, seg.raw_length)
                if seg.wire_length:
                    self.reporter.incr_counter(
                        TaskCounter.FRAMEWORK_GROUP,
                        TaskCounter.REDUCE_SHUFFLE_WIRE_BYTES,
                        seg.wire_length)
                self.reporter.incr_counter(
                    TaskCounter.FRAMEWORK_GROUP,
                    TaskCounter.REDUCE_SHUFFLE_SEGMENTS_DISK
                    if isinstance(seg, DiskSegment)
                    else TaskCounter.REDUCE_SHUFFLE_SEGMENTS_MEM, 1)

        def worker() -> None:
            while True:
                with lock:
                    if errors or outstanding[0] <= 0:
                        return
                if self._abort_check():
                    return
                try:
                    ready, m = work.get(timeout=0.05)
                except queue.Empty:
                    continue   # another fetcher may still requeue a map
                # the hold-off is read fresh at every pop: a success against
                # the address clears it, and the map goes at once
                hold = max(ready, self._penalized_until(m))
                now = time.monotonic()
                if hold > now:
                    # waiting out a penalty is liveness, not a hang: a tick
                    # for the node runner's reaper
                    if self.reporter is not None:
                        self.reporter.keepalive()
                    work.put((now, m))
                    time.sleep(min(hold - now, 0.05))
                    continue
                try:
                    # one fetch a round: the penalty box is the retry loop
                    seg = self._copy_one(m)
                except TaskKilledError as e:
                    with lock:
                        errors.append(e)
                    return
                except Exception as e:  # noqa: BLE001
                    if self._note_failure(m) is None:
                        with lock:
                            errors.append(e)
                        return
                    work.put((time.monotonic(), m))
                    continue
                land(m, seg)

        n = min(self.parallel, max(1, self.num_maps))
        threads = [threading.Thread(target=worker,
                                    name=f"shuffle-copier-{i}", daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        aborted = not errors and outstanding[0] > 0
        if errors or aborted:
            if self.merger is not None:
                self.merger.abort()
            for seg in results:
                if seg is not None:
                    seg.close()
            if errors:
                raise errors[0]
            raise TaskKilledError(f"reduce of partition {self.partition} "
                                  "stopped during its copy")
        out: "list[Segment]" = [seg for seg in results if seg is not None]
        if self.merger is not None:
            try:
                runs = self.merger.finish()
            except Exception:
                for seg in out:
                    seg.close()
                raise
            merged = self.merger.merged_ids
            # the merged runs first, then the other segments in map order:
            # every stream is sorted, and the final merge interleaves them
            out = list(runs) + [s for s in out if id(s) not in merged]
        return out

    @property
    def inmem_merges(self) -> int:
        return 0 if self.merger is None else self.merger.inmem_merges


class RemoteChunkSource:
    """A :data:`ChunkFetch` over the runners' RPC: each map's serving
    runner found by ``locate(map_index)`` (a ``tasktracker.MapLocator``,
    which returns an ``RpcClient`` to it), then ``get_map_output_chunk``
    ranges of at most ``tpumr.shuffle.chunk.bytes`` (64 KiB to 4 MiB).
    The node runner sets ``on_fetch_failure`` (its report to the master)
    and ``abort_check`` (the attempt was killed); ``serve_key`` names the
    output on the runner: the job id, or a handoff key."""

    def __init__(self, conf: Any, serve_key: str,
                 locate: Callable[[int], Any]) -> None:
        self.job_id = serve_key
        self.locate = locate
        # the server caps a chunk at 4 MiB; within the cap a chunk's
        # length is min(chunk_bytes, what remains)
        self.chunk_bytes = min(4 << 20, max(64 * 1024, _int(
            conf, "tpumr.shuffle.chunk.bytes")))
        #: a wire codec this process decodes, else "none"
        self.wire_codec = wire_codec_or_none(conf.get(
            "tpumr.shuffle.wire.codec",
            _DEFAULTS["tpumr.shuffle.wire.codec"]))
        self.on_fetch_failure: "Callable[[int, str], None] | None" = None
        self.abort_check: "Callable[[], bool] | None" = None

    @staticmethod
    def _decode(out: dict) -> dict:
        """Count the wire bytes and undo the wire codec in place: the
        chunk's ``data`` is then back in payload space, so offsets add
        up."""
        data = out.get("data", b"")
        out["wire_len"] = len(data)
        if out.get("wire"):
            out["data"] = get_codec(out["wire"]).decompress(data)
        return out

    def __call__(self, map_index: int, partition: int, offset: int) -> dict:
        return self._decode(self.locate(map_index).call(
            "get_map_output_chunk", self.job_id, map_index, partition,
            offset, self.chunk_bytes, self.wire_codec))

    def fetch_chunks(self, map_index: int, partition: int
                     ) -> "Iterator[dict]":
        """One segment's decoded chunks in order, one call at a time; an
        empty chunk before the end raises ``EOFError``."""
        got, total = 0, None
        while total is None or got < total:
            out = self(map_index, partition, got)
            total = int(out["total"])
            if not out["data"] and got < total:
                raise EOFError(f"empty chunk at {got}/{total} for map "
                               f"{map_index}")
            yield out
            got += len(out["data"])

    # the lost-output hooks, where the locator has them (MapLocator does)

    def addr_of(self, map_index: int) -> str:
        fn = getattr(self.locate, "addr_of", None)
        return fn(map_index) if fn is not None else ""

    def attempt_of(self, map_index: int) -> str:
        fn = getattr(self.locate, "attempt_of", None)
        return fn(map_index) if fn is not None else ""

    def invalidate(self, map_index: int) -> None:
        """Drop the cached address, so the next fetch resolves it from
        fresh completion events (a re-run map's new address)."""
        fn = getattr(self.locate, "invalidate", None)
        if fn is not None:
            fn(map_index)
