"""Reduce-side segments: lazy views over local spill files, and each map's
partition segment fetched from the node runner that serves it.

Counterpart of ``tpumr/mapred/shuffle_copier.py``, trimmed to two
sources. :class:`LocalSegmentSource` (``:231-247``) gives a reduce in the
map's process one :class:`DiskSegment` per map over the map's own file
(:func:`spill_region_segment`): nothing is read until the merge streams
it, chunk by chunk, through the codec's decompressor.
:class:`RemoteSegmentSource` polls the master's map-completion events
(``JobMaster.get_map_completion_events``) by cursor until every map of the
job has a live (not ``OBSOLETE``) event (:class:`EventFold`), takes each
map's serving address from it, fetches the reduce's partition with the
serving runner's ``get_map_output`` and parses the bytes by the codec it
names (:func:`fetch_segment`). ``reduce_task.run_reduce_task`` merges
either source's segments the same way. The streamed stage handoff
(``pipeline/handoff``) locates and fetches its partitions with the same
two helpers.

Left out (``ROADMAP.md``): the RAM-budgeted parallel copier and its memory
segments, the merge manager and its disk spills, chunked and pipelined
fetches, the batched fetch, fetch-failure reports and the penalty box. A
segment that cannot be fetched fails the reduce attempt, which the master
retries.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

from tpumr_torch.io import ifile
from tpumr_torch.ipc.rpc import RpcClient


class Segment:
    """One map output's partition segment, iterable as (kbytes, vbytes)."""

    #: raw (decompressed) bytes, which the merge's pass windows weigh
    raw_length = 0

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class DiskSegment(Segment):
    """A segment's payload in a region of a local file, its records
    streamed out in chunks through the codec's decompressor when the merge
    reads them. The file stays its writer's: ``close`` leaves it."""

    def __init__(self, path: str, codec: str, raw_length: int,
                 offset: int, length: int) -> None:
        self.path = path
        self.codec = codec
        self.raw_length = raw_length
        self.offset = offset
        self.length = length

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        return ifile.iter_chunked_segment(
            ifile.file_region_chunks(self.path, self.offset, self.length),
            self.codec)


def spill_region_segment(path: str, index: dict,
                         partition: int) -> DiskSegment:
    """A segment over one partition of an existing spill file."""
    off, raw_len, part_len = index["partitions"][partition]
    # past the 4-byte length: the payload is part_len - 4 bytes
    return DiskSegment(path, index.get("codec", "none"), raw_len,
                       offset=off + 4, length=part_len - 4)


class LocalSegmentSource:
    """``segments(partition)`` over the (path, index) outputs of the maps
    of this process, in map order; a map with no file (``""``) has no
    segment."""

    def __init__(self, map_outputs: "list[tuple[str, dict]]") -> None:
        self._outputs = map_outputs

    def segments(self, partition: int) -> "list[Segment]":
        return [spill_region_segment(path, index, partition)
                for path, index in self._outputs if path]


class TaskKilledError(RuntimeError):
    """The attempt was told to stop while it waited."""


class EventFold:
    """A completion feed of the master folded by cursor into index ->
    serving address. The feed is the map-completion dialect, which the
    streamed handoff's feed shares (``map_index`` holds its partition): an
    event announces the index's copy at ``shuffle_addr``, and an
    ``OBSOLETE`` event withdraws that copy. ``events_fn(cursor)`` returns
    the events from ``cursor``. Not thread-safe: a shared fold is polled
    under its owner's lock."""

    def __init__(self, events_fn: Callable[[int], "list[dict]"]) -> None:
        self._events_fn = events_fn
        self._cursor = 0
        #: index -> address of the runner serving it
        self.addr: "dict[int, str]" = {}

    def poll(self) -> "set[int]":
        """Fold the events past the cursor; return the indexes that had a
        copy withdrawn."""
        events = self._events_fn(self._cursor)
        self._cursor += len(events)
        withdrawn: "set[int]" = set()
        for e in events:
            m = int(e["map_index"])
            if e.get("status") == "OBSOLETE":
                if self.addr.get(m) == e.get("shuffle_addr"):
                    del self.addr[m]
                withdrawn.add(m)
            else:
                self.addr[m] = str(e["shuffle_addr"])
        return withdrawn


def fetch_segment(client: RpcClient, serve_key: str, index: int,
                  partition: int) -> Iterator[tuple[bytes, bytes]]:
    """One partition of an output that a runner serves under
    ``serve_key`` (a job id, or a handoff key), fetched whole with
    ``get_map_output`` and parsed by the codec it names."""
    got = client.call("get_map_output", serve_key, index, partition)
    return ifile.iter_transferred_segment(got["data"],
                                          got.get("codec", "none"))


class RemoteSegmentSource:
    """``segments(partition)``: one record iterator per map of the job, in
    map order. ``events_fn(cursor)`` returns the master's completion
    events from ``cursor``; ``abort_check()`` returning True stops the
    wait (the attempt was killed, or its runner is stopping)."""

    def __init__(self, job_id: str, num_maps: int,
                 events_fn: Callable[[int], "list[dict]"],
                 poll_s: float = 0.2, timeout_s: float = 600.0,
                 abort_check: "Callable[[], bool] | None" = None) -> None:
        self.job_id = job_id
        self.num_maps = num_maps
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self._abort_check = abort_check or (lambda: False)
        self._fold = EventFold(events_fn)

    def locations(self) -> "dict[int, str]":
        """Wait until every map has a serving address; return them."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            self._fold.poll()
            if len(self._fold.addr) >= self.num_maps:
                return dict(self._fold.addr)
            if self._abort_check():
                raise TaskKilledError(f"reduce of {self.job_id} stopped "
                                      "while waiting for map outputs")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.job_id}: {self.num_maps - len(self._fold.addr)}"
                    f" map outputs not available after {self.timeout_s}s")
            time.sleep(self.poll_s)

    def segments(self, partition: int
                 ) -> "list[Iterator[tuple[bytes, bytes]]]":
        locations = self.locations()
        clients: "dict[str, RpcClient]" = {}
        out = []
        try:
            for m in range(self.num_maps):
                addr = locations[m]
                cli = clients.get(addr)
                if cli is None:
                    host, port = addr.rsplit(":", 1)
                    cli = clients[addr] = RpcClient(host, int(port))
                out.append(fetch_segment(cli, self.job_id, m, partition))
        finally:
            for cli in clients.values():
                cli.close()
        return out

