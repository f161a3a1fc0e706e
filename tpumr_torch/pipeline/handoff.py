"""Streamed stage handoff: a reduce's output served over the shuffle wire
to the next stage's maps.

Counterpart of ``tpumr/pipeline/handoff.py``. The write side
(:class:`HandoffWriter`, driven by ``reduce_task``) tees the reduce's
emitted records into one single-partition IFile beside the job's own
output, under the node runner's handoff directory; the runner registers it
after the commit under the serving key ``handoff:<job>``
(:func:`serve_key`), so its existing ``get_map_output`` serves it as it
serves a map's partition.

The read side (:class:`PipelineHandoffInputFormat` over
:class:`HandoffSplit`) is a downstream map whose split is one upstream
reduce partition. It locates the partition on the master's handoff feed
(``JobMaster.get_handoff_completion_events``: the map-completion dialect,
``map_index`` holding the partition, ``OBSOLETE`` tombstones for the
copies of a lost runner) through the runner's :class:`HandoffSource`
(:func:`make_handoff_source`, ``:371``: the shuffle's
``tasktracker.MapLocator`` over that feed, one locate slice at a time),
and streams the segment in chunks from the runner serving it
(``shuffle_copier.RemoteChunkSource.fetch_chunks``). A partition the
stream cannot serve, withdrawn or failing, falls back to the upstream
stage's committed SequenceFile part file, which holds the same records: the
committed output stays the truth. Each split adds one to the ``Pipeline``
group's ``HANDOFF_STREAMED_SPLITS`` or ``HANDOFF_DFS_FALLBACK_SPLITS``.

Left out: the pipelined chunk window (``call_begin``/``call_finish`` on
leased connections, ``:585-695``): chunks are asked for one at a time.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator

from tpumr_torch.io import ifile
from tpumr_torch.io.writable import deserialize, serialize
from tpumr_torch.mapred.shuffle_copier import RemoteChunkSource
from tpumr_torch.mapred.split import InputSplit

#: one locate attempt's budget before the reader tries the fallback
_LOCATE_SLICE_S = 2.0

#: counters of the reader, one per split
COUNTER_GROUP = "Pipeline"
COUNTER_STREAMED = "HANDOFF_STREAMED_SPLITS"
COUNTER_FALLBACK = "HANDOFF_DFS_FALLBACK_SPLITS"

#: serving-key namespace on the runner: handoff entries sit beside map
#: outputs, keyed apart from the job id so that the job's cleanup leaves
#: them to the pipeline
SERVE_PREFIX = "handoff:"

#: defaults of the reader's keys, the JAX package's (its confkeys registry)
_DEFAULT_TIMEOUT_MS = 600_000
_DEFAULT_POLL_MS = 200


def serve_key(job_id: str) -> str:
    return SERVE_PREFIX + job_id


# ----------------------------------------------------------------- write


class HandoffWriter:
    """The tee of one reduce attempt's output records: a single-partition
    IFile, the map-output framing the runner already serves."""

    def __init__(self, path: str, codec: str = "none") -> None:
        self.path = path
        self._f = open(path, "wb")
        self._w = ifile.Writer(self._f, codec=codec)
        self._w.start_partition()
        self._n = 0

    def append(self, key: Any, value: Any) -> None:
        self._w.append_raw(serialize(key), serialize(value))
        self._n += 1

    def finish(self, partition: int) -> dict:
        """Close; returns what the runner registers for serving."""
        self._w.end_partition()
        index = self._w.close()
        self._f.close()
        return {"path": self.path, "index": index, "partition": partition,
                "records": self._n}

    def abort(self) -> None:
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    @staticmethod
    def open_for(conf: Any, task: Any) -> "HandoffWriter | None":
        """A writer where this reduce attempt streams its output: the stage
        opted in and the runtime gave it a handoff directory (a node runner
        does; the local runner serves nothing)."""
        if not conf.get_boolean("tpumr.pipeline.stream.handoff", False):
            return None
        d = conf.get("tpumr.pipeline.handoff.dir")
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        return HandoffWriter(os.path.join(d, f"{task.attempt_id}.handoff"))


# ------------------------------------------------------------------ read


@dataclass
class HandoffSplit(InputSplit):
    """One upstream reduce partition as a downstream map's input: fetched
    from the runner that committed it, else read from the upstream stage's
    committed part file."""

    upstream_job: str = ""
    partition: int = 0
    #: the upstream stage's mapred.output.dir: the fallback's root
    fallback_dir: str = ""

    def describe(self) -> str:
        return f"{self.upstream_job}[r{self.partition}]"


def build_handoff_splits(upstream_job: str, num_reduces: int,
                         output_dir: str,
                         serving: "dict[int, str] | None" = None
                         ) -> "list[HandoffSplit]":
    """The master's splits of a streamed stage: one per upstream reduce
    partition, with the serving runner's host as the locality hint where
    the partition is already committed (``serving``: partition ->
    shuffle address)."""
    serving = serving or {}
    out = []
    for p in range(num_reduces):
        addr = serving.get(p, "")
        host = addr.rsplit(":", 1)[0] if addr else ""
        out.append(HandoffSplit(locations=[host] if host else [],
                                upstream_job=upstream_job, partition=p,
                                fallback_dir=output_dir))
    return out


@dataclass
class HandoffSource:
    """The runner's stream source for one upstream job, shared by the
    downstream maps on that runner: a ``tasktracker.MapLocator`` over the
    master's handoff feed, partition -> serving address."""

    locator: Any = None
    upstream_job: str = ""

    def locate(self, partition: int) -> "str | None":
        """The serving address of ``partition``; None where its copy was
        withdrawn (its runner was lost: a reduce that committed is never
        rerun, so only the fallback can serve it); ``TimeoutError`` when it
        is not announced within the slice."""
        from tpumr_torch.mapred.tasktracker import OutputWithdrawn
        try:
            return self.locator.resolve(partition)
        except OutputWithdrawn:
            return None

    def invalidate(self, partition: int) -> None:
        """The address failed to serve: the locator keeps it only as a
        fallback until the master replaces or withdraws it."""
        self.locator.invalidate(partition)

    def close(self) -> None:
        self.locator.close()


def make_handoff_source(upstream_job: str,
                        events_fn: Callable[[int], "list[dict]"],
                        poll_s: float = 0.2) -> HandoffSource:
    """The runner's source: a ``MapLocator`` over the handoff feed whose
    resolve gives up after one short slice, so that the reader can look
    for the committed part between slices, and which takes a withdrawn
    partition as gone."""
    from tpumr_torch.mapred.tasktracker import make_map_locator
    return HandoffSource(
        locator=make_map_locator(events_fn, poll_s=poll_s,
                                 timeout_s=_LOCATE_SLICE_S,
                                 withdrawn_is_final=True),
        upstream_job=upstream_job)


class PipelineHandoffInputFormat:
    """Input format of a streamed stage. Its splits are built by the
    master when it submits the stage (:func:`build_handoff_splits`), so
    :meth:`get_splits` refuses."""

    def get_splits(self, conf: Any, num_splits: int):
        raise RuntimeError(
            "PipelineHandoffInputFormat splits are built by the pipeline "
            "engine when it submits the stage: submit this job through a "
            "pipeline")

    def get_record_reader(self, split: HandoffSplit, conf: Any,
                          reporter: Any = None
                          ) -> Iterator[tuple[Any, Any]]:
        assert isinstance(split, HandoffSplit), split
        timeout_s = conf.get_int("tpumr.pipeline.handoff.timeout.ms",
                                 _DEFAULT_TIMEOUT_MS) / 1000.0
        poll_s = conf.get_int("tpumr.pipeline.handoff.poll.ms",
                              _DEFAULT_POLL_MS) / 1000.0
        # the node runner's seam: a factory of per-upstream-job sources;
        # absent outside a runner, where only the fallback reads
        factory = conf.get("tpumr.pipeline.handoff.source")
        src = factory(split.upstream_job) if callable(factory) else None
        deadline = time.monotonic() + timeout_s
        while True:
            if src is not None:
                records = self._try_stream(src, split, conf)
                if records is not None:
                    self._count(reporter, COUNTER_STREAMED)
                    return records
            records = self._try_fallback(split, conf)
            if records is not None:
                self._count(reporter, COUNTER_FALLBACK)
                return records
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"handoff partition {split.describe()} was neither "
                    f"streamed nor committed within {timeout_s:.0f}s")
            time.sleep(poll_s)

    @staticmethod
    def _count(reporter: Any, name: str) -> None:
        if reporter is not None:
            reporter.incr_counter(COUNTER_GROUP, name)

    @staticmethod
    def _try_stream(src: HandoffSource, split: HandoffSplit, conf: Any
                    ) -> "Iterator[tuple[Any, Any]] | None":
        """One bounded attempt at the stream: locate the serving runner on
        the handoff feed and read the partition's first chunk. None: not
        (yet) streamable, and the caller tries the fallback."""
        try:
            addr = src.locate(split.partition)
        except TimeoutError:
            return None
        if addr is None:
            return None
        fetch = RemoteChunkSource(conf, serve_key(split.upstream_job),
                                  lambda _p: src.locator.client(addr))
        chunks = fetch.fetch_chunks(split.partition, 0)
        try:
            first = next(chunks)
        except Exception:  # noqa: BLE001 — the runner is gone or lost the
            # entry: demote the address and read the committed part file
            src.invalidate(split.partition)
            return None

        def gen() -> Iterator[tuple[Any, Any]]:
            payloads = (c["data"] for c in itertools.chain([first], chunks))
            for kb, vb in ifile.iter_chunked_segment(
                    payloads, first.get("codec", "none")):
                yield deserialize(kb), deserialize(vb)

        return gen()

    @staticmethod
    def _try_fallback(split: HandoffSplit, conf: Any
                      ) -> "Iterator[tuple[Any, Any]] | None":
        """The committed part file, once the upstream stage's commit made
        it visible."""
        from tpumr_torch.fs.filesystem import FileSystem, Path
        from tpumr_torch.io import sequencefile
        from tpumr_torch.mapred.output_formats import part_name
        path = str(Path(split.fallback_dir).child(part_name(split.partition)))
        fs = FileSystem.get(path, conf)
        try:
            if not fs.exists(path):
                return None
            length = fs.get_status(path).length
        except OSError:
            return None

        def gen() -> Iterator[tuple[Any, Any]]:
            f = fs.open(path)
            try:
                yield from sequencefile.Reader(f).iter_range(0, length)
            finally:
                f.close()

        return gen()
