"""Reduce-side shuffle fetch on a cluster: each map's partition segment,
fetched from the node runner that serves it.

Counterpart of ``tpumr/mapred/shuffle_copier.py``, trimmed to one
sequential source. :class:`RemoteSegmentSource` polls the master's
map-completion events (``JobMaster.get_map_completion_events``) by cursor
until every map of the job has a live (not ``OBSOLETE``) event, takes each
map's serving address from it, fetches the reduce's partition with the
serving runner's ``get_map_output`` and parses the bytes
(``io/ifile.iter_transferred_segment``). ``reduce_task.run_reduce_task``
merges the segments as it merges local files.

Left out (``ROADMAP.md``): the RAM-budgeted parallel copier, the merge
manager and its disk spills, chunked and pipelined fetches, the batched
fetch, fetch-failure reports and the penalty box. A segment that cannot
be fetched fails the reduce attempt, which the master retries.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

from tpumr_torch.io import ifile
from tpumr_torch.ipc.rpc import RpcClient


class TaskKilledError(RuntimeError):
    """The attempt was told to stop while it waited."""


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
        self._events_fn = events_fn
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self._abort_check = abort_check or (lambda: False)
        self._cursor = 0
        #: map index -> address of the runner serving its output
        self._addr: "dict[int, str]" = {}

    def _fold(self, events: "list[dict]") -> None:
        for e in events:
            m = int(e["map_index"])
            if e.get("status") == "OBSOLETE":
                if self._addr.get(m) == e.get("shuffle_addr"):
                    del self._addr[m]
            else:
                self._addr[m] = str(e["shuffle_addr"])

    def locations(self) -> "dict[int, str]":
        """Wait until every map has a serving address; return them."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            events = self._events_fn(self._cursor)
            self._cursor += len(events)
            self._fold(events)
            if len(self._addr) >= self.num_maps:
                return dict(self._addr)
            if self._abort_check():
                raise TaskKilledError(f"reduce of {self.job_id} stopped "
                                      "while waiting for map outputs")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.job_id}: {self.num_maps - len(self._addr)} map "
                    f"outputs not available after {self.timeout_s}s")
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
                got = cli.call("get_map_output", self.job_id, m, partition)
                out.append(ifile.iter_transferred_segment(
                    got["data"], got.get("codec", "none")))
        finally:
            for cli in clients.values():
                cli.close()
        return out

