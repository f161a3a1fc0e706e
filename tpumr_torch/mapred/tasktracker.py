"""The node runner: CPU, accelerator and reduce slots on one host, a
heartbeat to the job master, task threads, and the shuffle server.

Counterpart of ``NodeRunner`` in ``tpumr/mapred/tasktracker.py``:

- slots: ``mapred.tasktracker.map.cpu.tasks.maximum``,
  ``mapred.tasktracker.map.tpu.tasks.maximum`` (accelerator map slots) and
  ``mapred.tasktracker.reduce.tasks.maximum``, each a semaphore;
- the status of every heartbeat (``:913`` there): the slots, the running
  count of each pool, the free device ids (``available_tpu_devices``,
  derived from the running accelerator attempts), the host, every
  attempt's :class:`TaskStatus` and the reduces' fetch-failure reports;
  the runner asks for work when any pool has room;
- the heartbeat loop (``:965-1144``): every
  ``tpumr.heartbeat.interval.ms``, the first beat marked as the initial
  contact, the master's response id echoed back; terminal statuses and the
  fetch-failure reports sent are dropped once a response arrived
  (``:1120-1122``), and the response's actions applied
  (:meth:`NodeRunner._apply_action`: launch, kill, job cleanup, ``reinit``
  and ``recover_job``); a beat that fails is retried, its error kept on
  :attr:`NodeRunner.heartbeat_error` and logged once per distinct error;
- the lost master (``:453-470, 981-1001, 1090``): a beat that fails in
  transport (the master died, restarts or is cut off) sets
  :attr:`NodeRunner.master_unreachable`; the attempts go on running,
  nothing is killed or reset, and the beats back off, doubling up to
  ``tpumr.heartbeat.lostmaster.backoff.max.ms`` (default 15,000) with
  jitter; the first beat that lands clears it, and a restarted master
  adopts the runner's work from that beat. A ``recover_job`` action
  (``:1266-1275``) names a job the restarted master resubmitted: the
  outputs served under the old id move to the new one, later ones are
  registered under it, and a fetch under either id finds them
  (:meth:`NodeRunner._map_output_entry`, ``:2113-2139``);
- a thread per attempt (``_launch``, ``_run_task_inner``, ``:1572-1697``):
  a map runs the port's ``map_task.run_map_task``, whose ``task.run_on_tpu``
  picks ``GpuMapRunner`` (the card ``cuda:tpu_device_id``) or the CPU
  slot's runner, and registers its output for the shuffle, its index
  stamped with the attempt and its number (``:1598``); a reduce runs
  ``reduce_task.run_reduce_task`` over a ``shuffle_copier.RemoteChunkSource``
  (:meth:`NodeRunner._remote_fetch_factory`, ``:2269-2280``) whose fetch
  failures the runner reports to the master
  (:meth:`NodeRunner.report_fetch_failure`, ``:2063-2076``), and a
  device-shuffled job's gang reduce runs ``device_shuffle.run_device_reduce``
  over every map's dense output (``:1615-1623``, ``:2282-2294``); output is
  committed through the master's ``can_commit``. An exception fails the
  attempt, and its type, message and traceback reach the master as the
  status's diagnostics;
- :class:`MapLocator` (``:63-300``): the master's completion feed (map
  outputs, or a pipeline's handoff partitions) folded by cursor into index
  -> serving address, ``OBSOLETE`` events evicting; ``invalidate`` demotes
  an address to a fallback kept until the master replaces or withdraws it;
  the reduce's copier and the stream handoff both locate through it;
- the shuffle server (``:2095-2232``): :meth:`NodeRunner.get_map_output`
  (a partition whole), :meth:`NodeRunner.get_map_output_chunk` (a bounded
  range, :func:`serve_chunk`, read through an ``io/fdcache.FdCache`` and
  wire-compressed where that pays) and
  :meth:`NodeRunner.get_map_output_dense` (a device-shuffled map's dense
  file whole), each refusing the other kind of output; the serving seams
  ``shuffle.serve[.m<i>|.a<n>]`` of ``utils/fi``; a reduce's copy spills
  and merge runs go under ``tpumr.task.local.dir``, the job's ``shuffle``
  directory (``:1364``);
- the pipeline handoff: a streaming stage's reduces tee their output under
  the runner's ``handoff`` directory, outside the job's scratch tree
  (``:1371-1391``); only the attempt that won the commit registers its tee
  for serving, under ``handoff:<job>`` (``:1615-1657``); a downstream
  stage's maps get :meth:`NodeRunner._handoff_source` through the conf
  (``:2247``); every ``PURGE_EVERY_BEATS`` heartbeats the runner drops the
  handoff entries whose pipeline has ended, as the master's
  ``handoff_purgeable`` says (``:1147-1177``);
- the node's self-checks (``:615-650``, ``mapred/node_health.py``): the
  health script's verdict and report go in every status, and the master
  gives an unhealthy runner no task; ``TpuDeviceHealth`` counts each
  accelerator attempt's end against its card (:meth:`NodeRunner.
  _note_device_result`, ``:1699-1713``): ``tpumr.tpu.device.quarantine.
  failures`` (default 3; 0 turns it off) device-classed failures in a row
  take the card out, and the next status advertises one accelerator slot
  fewer and the card as not free, until the probe (every
  ``tpumr.tpu.device.probe.interval.ms``, backing off to ``...max.
  interval.ms``) passes on it again;
- the failure class: a FAILED attempt's status carries the class its site
  tagged, else ``task.classify_exception``'s (``:1680-1697``);
- the hung-task reaper (``:1715-1835``): a thread that samples each running
  attempt's progress signature (phase, progress, and its live reporter's
  status, counters and ticks) every quarter of the smallest
  ``mapred.task.timeout`` in force (0.1-5 s; recomputed as soon as a job's
  conf arrives, where the JAX package waits out the old interval), and
  fails an attempt whose
  signature stayed still for its job's timeout (default 600,000 ms; 0 or
  less turns it off) with class ``timeout``, setting its kill flag. A map
  polls the flag at its record and batch boundaries and ends; one that
  cannot poll (inside a CUDA synchronise) keeps its thread, but its slot
  counts as free from the next status. The settle guards keep a late
  finisher from registering output, committing or changing the reaped
  status. :meth:`NodeRunner.metrics` reports the reaps, the quarantines
  and the live task threads.

The node decides its device: ``tpumr_torch.device`` of the runner's conf,
``cuda`` by default, is set on every job conf it runs, so a job cannot move
its accelerator-slot maps elsewhere. A runner with accelerator slots and no
CUDA raises at construction unless the conf asks for the CPU. It has
``torch.cuda.device_count()`` devices on ``cuda`` unless told how many
(``n_tpu_devices``), and ``n_tpu_devices`` or 1 on the CPU, where its
accelerator-slot maps take the kernels' plain torch versions.

Process isolation (``:1542-1557``, ``:1963-2100``): with
``tpumr.task.isolation=process`` in the job's conf, else the runner's, a
CPU-slot attempt runs in a child process (:meth:`NodeRunner.
_isolate_in_process`, ``mapred/process_runner.py``, ``mapred/child.py``).
Accelerator-slot attempts and a device-shuffled job's gang reduce always
stay in the runner, which holds the CUDA context and the split cache; so do
the attempts of a pipeline stage that streams its handoff or reads one,
whose handoff objects live in the runner. The child reports over the
umbilical, the runner's RPC methods ``umbilical_ping``, ``_status``,
``_can_commit`` (proxied to the master), ``_events`` (the master's
completion feed, for an isolated reduce's map locator), ``_done`` (which
registers a map's output for serving), ``_fail`` and
``_report_fetch_failure``. An attempt's kill flag, a kill action's or the
reaper's, SIGKILLs its child's process group; the reaper's signature of an
isolated attempt is its pushed phase, progress, counters and ticks. The
node's ``node_health.GLOBAL_MEMORY_MANAGER`` kills a child above
``mapred.task.limit.maxrss.mb``. The umbilical is unauthenticated, as is
all of the port's RPC. A job's file cache (a pipes job's executables,
``mapred/filecache.py``) is localised under ``<local root>/cache``
(``tpumr.cache.dir``) and released when the job is cleaned up.

Left out (``ROADMAP.md``): the serving and purging of userlogs (a child's
log is kept under ``userlogs/<job>/<attempt>/child.log``, no more),
profiles, the batched map-output serving (``serve_batch``), the
locator's pooled connections (``RpcClientPool``: here each fetching thread
keeps one ``RpcClient`` per address, and the locator closes them all), the
heartbeat delta encoding (so the ``resend_full`` action) and the HTTP
page.
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import tempfile
import threading
import time
import traceback

from typing import Any, Callable

from tpumr_torch.device import DEVICE_KEY, select_device
from tpumr_torch.io import ifile
from tpumr_torch.io.compress import wire_compress
from tpumr_torch.io.fdcache import FdCache
from tpumr_torch.ipc.rpc import RpcClient, RpcServer
from tpumr_torch.mapred import filecache
from tpumr_torch.mapred.api import Reporter, TaskKilledError
from tpumr_torch.mapred.ids import TaskAttemptID, TaskID
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.jobtracker import PROTOCOL_VERSION
from tpumr_torch.mapred.map_task import run_map_task
from tpumr_torch.mapred.node_health import (NodeHealthChecker,
                                            TpuDeviceHealth, cpu_probe,
                                            default_tpu_probe)
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.process_runner import run_task_in_process
from tpumr_torch.mapred.reduce_task import run_reduce_task
from tpumr_torch.mapred.shuffle_copier import RemoteChunkSource
from tpumr_torch.mapred.task import (FailureClass, Task, TaskPhase,
                                     TaskState, TaskStatus,
                                     classify_exception)
from tpumr_torch.pipeline.handoff import (SERVE_PREFIX, HandoffSource,
                                          make_handoff_source, serve_key)
from tpumr_torch.utils.fi import maybe_fail

#: seconds ``stop`` waits for each of the runner's threads
JOIN_TIMEOUT_S = 10.0
#: heartbeats between two sweeps of the handoff entries
PURGE_EVERY_BEATS = 20
#: ``mapred.task.timeout``'s default, ms (the JAX package's)
TASK_TIMEOUT_MS = 600_000

_log = logging.getLogger(__name__)


class OutputWithdrawn(LookupError):
    """The index's copy was withdrawn and nothing replaced it (a locator
    built with ``withdrawn_is_final``: a handoff partition is never
    rerun)."""


class MapLocator:
    """Where each map's output is served: the master's append-only
    completion feed (``events_fn(cursor)`` returns the events from
    ``cursor``) folded into index -> latest event. An ``OBSOLETE`` event
    evicts the attempt it names (a tombstone for an attempt not cached
    does nothing). ``locator(index)`` blocks until the index has an
    address and returns an ``RpcClient`` to it, one per (thread, address).

    :meth:`invalidate` demotes a cached address to a fallback: the next
    resolve polls for a fresh event first, and with none it takes the
    fallback back, since the fault may be on this reducer's side and the
    cursor-based feed never sends the old event again; an ``OBSOLETE`` for
    it kills the fallback too. After 25 polls in a row that brought
    nothing, the cursor rewinds to 0 (folding is idempotent). ``on_wait``,
    where set, is called at each poll of a blocked resolve (the node
    runner raises there when the attempt was killed). Thread-safe: the
    feed is polled under one lock, outside the cache's."""

    def __init__(self, events_fn: Callable[[int], "list[dict]"],
                 poll_s: float = 0.2, timeout_s: float = 600.0,
                 withdrawn_is_final: bool = False) -> None:
        self._events_fn = events_fn
        self._poll_s = poll_s
        self._timeout_s = timeout_s
        self._withdrawn_is_final = withdrawn_is_final
        self.on_wait: "Callable[[], None] | None" = None
        self._events: "dict[int, dict]" = {}
        #: invalidated addresses, kept until replaced or withdrawn
        self._stale: "dict[int, dict]" = {}
        #: indexes whose copy was withdrawn and not replaced
        self._withdrawn: "set[int]" = set()
        self._seen = 0
        self._empty_polls = 0
        self._clients: "dict[tuple[int, str], RpcClient]" = {}
        self._closed = False
        self._cache_lock = threading.Lock()
        self._poll_lock = threading.Lock()

    def _fold(self, fresh: "list[dict]") -> None:
        """Apply a batch of events. Caller holds ``_cache_lock``."""
        self._seen += len(fresh)
        for e in fresh:
            idx = int(e["map_index"])
            if e.get("status") == "OBSOLETE":
                cur = self._events.get(idx)
                if cur is not None and cur["attempt_id"] == e["attempt_id"]:
                    del self._events[idx]
                st = self._stale.get(idx)
                if st is not None and st["attempt_id"] == e["attempt_id"]:
                    del self._stale[idx]   # withdrawn: no fallback now
                if idx not in self._events and idx not in self._stale:
                    self._withdrawn.add(idx)
            else:
                self._events[idx] = e
                self._stale.pop(idx, None)
                self._withdrawn.discard(idx)

    def _entry(self, map_index: int) -> "dict | None":
        """Caller holds ``_cache_lock``."""
        e = self._events.get(map_index)
        return e if e is not None else self._stale.get(map_index)

    def attempt_of(self, map_index: int) -> str:
        """The attempt whose output the cached (or fallback) address
        serves: what a fetch-failure report names."""
        with self._cache_lock:
            e = self._entry(map_index)
            return e["attempt_id"] if e is not None else ""

    def addr_of(self, map_index: int) -> str:
        with self._cache_lock:
            e = self._entry(map_index)
            return str(e["shuffle_addr"]) if e is not None else ""

    def size_of(self, map_index: int) -> int:
        """Output bytes the cached event announced (0: unknown)."""
        with self._cache_lock:
            e = self._entry(map_index)
            return int(e.get("output_bytes", 0) or 0) if e is not None else 0

    def invalidate(self, map_index: int) -> None:
        with self._cache_lock:
            e = self._events.pop(map_index, None)
            if e is not None:
                self._stale[map_index] = e

    def __call__(self, map_index: int) -> RpcClient:
        return self.client(self.resolve(map_index))

    def client(self, addr: str) -> RpcClient:
        """This thread's client to ``addr``."""
        key = (threading.get_ident(), addr)
        with self._cache_lock:
            if self._closed:
                raise RuntimeError("map locator closed")
            cli = self._clients.get(key)
            if cli is None:
                host, port = addr.rsplit(":", 1)
                cli = self._clients[key] = RpcClient(host, int(port))
            return cli

    def resolve(self, map_index: int) -> str:
        """Block until the index has an address ("host:port") and return
        it; ``TimeoutError`` after ``timeout_s``."""
        deadline = time.monotonic() + self._timeout_s
        while True:
            with self._cache_lock:
                e = self._events.get(map_index)
                if e is not None:
                    return str(e["shuffle_addr"])
            with self._poll_lock:
                with self._cache_lock:
                    cached = map_index in self._events
                if cached:         # another thread's poll brought it
                    continue
                try:
                    fresh = self._events_fn(self._seen)
                except Exception:  # noqa: BLE001 — the master is away for
                    fresh = []     # a moment: poll again until the deadline
                with self._cache_lock:
                    self._fold(fresh)
                    if fresh:
                        self._empty_polls = 0
                    cached = map_index in self._events
            if cached:
                continue
            with self._cache_lock:
                self._empty_polls += 1
                if self._empty_polls >= 25:
                    self._empty_polls = 0
                    self._seen = 0
                stale = self._stale.pop(map_index, None)
                if stale is not None:
                    # nothing fresh: the demoted address is still the best
                    # known one until the master replaces or withdraws it
                    self._events[map_index] = stale
                    continue
                if self._withdrawn_is_final and \
                        map_index in self._withdrawn:
                    raise OutputWithdrawn(f"output {map_index} withdrawn")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"map {map_index} output never became available")
            if self.on_wait is not None:
                self.on_wait()
            time.sleep(self._poll_s)

    def close(self) -> None:
        """Close every client; a later ``client`` call raises."""
        with self._cache_lock:
            self._closed = True
            clients, self._clients = list(self._clients.values()), {}
        for cli in clients:
            cli.close()


def make_map_locator(events_fn: Callable[[int], "list[dict]"],
                     poll_s: float = 0.2, timeout_s: float = 600.0,
                     withdrawn_is_final: bool = False) -> MapLocator:
    return MapLocator(events_fn, poll_s=poll_s, timeout_s=timeout_s,
                      withdrawn_is_final=withdrawn_is_final)


def serve_chunk(fds: FdCache, path: str, index: dict, partition: int,
                offset: int, max_bytes: int, max_chunk: int,
                wire: str = "none") -> dict:
    """One bounded chunk of one partition's payload, read off the fd
    cache: ``min(max_bytes, max_chunk, what remains)`` bytes from
    ``offset`` (payload-relative), with the payload's length (``total``),
    its raw length, its codec and the length covered (``n``); compressed
    for the wire where that pays (``io/compress.wire_compress``)."""
    off, raw_len, part_len = index["partitions"][partition]
    payload_len = part_len - 4          # less the length prefix
    offset = max(0, int(offset))
    n = max(0, min(int(max_bytes), max_chunk, payload_len - offset))
    data = fds.pread(path, n, off + 4 + offset)
    out = {"data": data, "total": payload_len, "raw": raw_len,
           "codec": index.get("codec", "none"), "n": n}
    wire_compress(out, wire)
    return out


class NodeRunner:
    def __init__(self, master_host: str, master_port: int, conf: JobConf,
                 name: "str | None" = None, host: str = "127.0.0.1",
                 n_tpu_devices: "int | None" = None) -> None:
        self.conf = conf
        #: locality name reported to the scheduler
        self.host = host
        self.name = name or f"tracker_{host}_{id(self) & 0xffff}"
        self.max_cpu_map_slots = conf.get_int(
            "mapred.tasktracker.map.cpu.tasks.maximum", 3)
        self.max_tpu_map_slots = conf.get_int(
            "mapred.tasktracker.map.tpu.tasks.maximum", 1)
        self.max_reduce_slots = conf.get_int(
            "mapred.tasktracker.reduce.tasks.maximum", 2)
        self.device_key = str(conf.get(DEVICE_KEY) or "cuda")
        on_cpu = True
        if self.max_tpu_map_slots > 0:
            # no CUDA and no request for the CPU: raise, never run the
            # accelerator slots somewhere else
            dev = select_device(conf)
            on_cpu = dev.type == "cpu"
            if on_cpu:
                self.n_tpu_devices = n_tpu_devices or 1
            else:
                import torch
                self.n_tpu_devices = (n_tpu_devices if n_tpu_devices
                                      is not None
                                      else torch.cuda.device_count())
        else:
            self.n_tpu_devices = 0
        self.heartbeat_s = conf.get_int("tpumr.heartbeat.interval.ms",
                                        1000) / 1000.0
        self.master = RpcClient(master_host, master_port,
                                retries=conf.get_int(
                                    "tpumr.rpc.client.retries", 1))
        remote = self.master.call("get_protocol_version")
        if remote != PROTOCOL_VERSION:
            self.master.close()
            raise RuntimeError(f"master protocol {remote} != "
                               f"{PROTOCOL_VERSION}")
        self.lock = threading.RLock()
        self.running: "dict[str, TaskStatus]" = {}
        self.running_tasks: "dict[str, Task]" = {}
        self._kill_requested: "set[str]" = set()
        #: (job id, map index) -> (IFile path, index) served to reduces
        self.map_outputs: "dict[tuple[str, int], tuple[str, dict]]" = {}
        #: the reduces' fetch-failure reports, sent with the next beat
        self._fetch_failures: "list[dict]" = []
        #: open spill files of the chunk server
        self._spill_fds = FdCache(conf.get_int("tpumr.shuffle.fd.cache.size",
                                               64))
        self.job_confs: "dict[str, JobConf]" = {}
        self.local_root = tempfile.mkdtemp(
            prefix=f"tpumr_torch-{self.name}-",
            dir=conf.get("mapred.local.dir") or None)
        self._response_id = 0
        self._initial_contact = True
        #: the last failed beat's error ("" after a beat that went through)
        self.heartbeat_error = ""
        #: set while the master cannot be reached in transport: the
        #: attempts go on, the beats back off; cleared by a beat that lands
        self.master_unreachable = False
        self._master_failures = 0
        self._lost_master_backoff_max_s = conf.get_int(
            "tpumr.heartbeat.lostmaster.backoff.max.ms", 15_000) / 1000.0
        #: old job id -> the id a restarted master resubmitted it as
        self._job_rebinds: "dict[str, str]" = {}
        self._stop = threading.Event()
        self._cpu_sem = threading.Semaphore(max(1, self.max_cpu_map_slots))
        self._tpu_sem = threading.Semaphore(max(1, self.max_tpu_map_slots))
        self._red_sem = threading.Semaphore(max(1, self.max_reduce_slots))
        self._task_threads: "set[threading.Thread]" = set()
        #: upstream job -> the stream source its downstream maps share
        self._handoff_sources: "dict[str, HandoffSource]" = {}
        self._beats = 0
        script = conf.get("mapred.healthChecker.script.path")
        self.health: "NodeHealthChecker | None" = (
            NodeHealthChecker(script, interval_s=conf.get_int(
                "mapred.healthChecker.interval.ms", 10_000) / 1000.0)
            if script else None)
        dq_threshold = conf.get_int("tpumr.tpu.device.quarantine.failures", 3)
        self.device_health: "TpuDeviceHealth | None" = None
        if self.max_tpu_map_slots > 0 and dq_threshold > 0:
            self.device_health = TpuDeviceHealth(
                self.n_tpu_devices, threshold=dq_threshold,
                probe=cpu_probe if on_cpu else default_tpu_probe,
                probe_interval_s=conf.get_int(
                    "tpumr.tpu.device.probe.interval.ms", 10_000) / 1000.0,
                probe_max_interval_s=conf.get_int(
                    "tpumr.tpu.device.probe.max.interval.ms",
                    300_000) / 1000.0)
        #: the reaper's books: when each running attempt last showed
        #: progress (monotonic), its last signature, and its live reporter
        self._last_progress: "dict[str, float]" = {}
        self._progress_sigs: "dict[str, tuple]" = {}
        self._live_reporters: "dict[str, Reporter]" = {}
        #: an isolated attempt's last pushed ticks, and its child's pid
        self._umb_ticks: "dict[str, int]" = {}
        self._children: "dict[str, int]" = {}
        self.tasks_reaped_timeout = 0
        self.tpu_device_quarantines = 0
        #: set when a job's conf arrives (its timeout may be the smallest)
        #: and at stop: the reaper recomputes its wait at once
        self._reaper_wake = threading.Event()
        self._server = RpcServer(self, "127.0.0.1", 0)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"heartbeat-{self.name}",
            daemon=True)
        self._reaper_thread = threading.Thread(
            target=self._reaper_loop, name=f"task-reaper-{self.name}",
            daemon=True)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "NodeRunner":
        # the health script's first verdict goes with the first heartbeat:
        # an unhealthy node must not take a task before its script has run
        if self.health is not None:
            self.health.start()
        self._server.start()
        self._hb_thread.start()
        self._reaper_thread.start()
        return self

    def stop(self) -> None:
        """Stop heartbeating and reaping, join the task threads (each for
        at most ``JOIN_TIMEOUT_S``; a running task sees its kill flag set),
        stop the self-checks, close the shuffle server and the master
        connection, and delete the runner's local directory."""
        self._stop.set()
        self._reaper_wake.set()
        for t in (self._hb_thread, self._reaper_thread):
            if t.is_alive():
                t.join(JOIN_TIMEOUT_S)
        with self.lock:
            threads = list(self._task_threads)
        for t in threads:
            t.join(JOIN_TIMEOUT_S)
        if self.health is not None:
            self.health.stop()
        if self.device_health is not None:
            self.device_health.stop()
        self._server.stop()
        self.master.close()
        with self.lock:
            sources = list(self._handoff_sources.values())
            self._handoff_sources.clear()
        for src in sources:
            src.close()
        self._spill_fds.invalidate()
        shutil.rmtree(self.local_root, ignore_errors=True)

    @property
    def shuffle_port(self) -> int:
        return self._server.port

    # ------------------------------------------------------------ status

    def _counts(self) -> tuple[int, int, int]:
        cpu = tpu = red = 0
        for st in self.running.values():
            if st.state != TaskState.RUNNING:
                continue
            if not st.is_map:
                red += 1
            elif st.run_on_tpu:
                tpu += 1
            else:
                cpu += 1
        return cpu, tpu, red

    def _quarantined(self) -> "list[int]":
        return (self.device_health.quarantined()
                if self.device_health is not None else [])

    def _available_tpu_devices(self) -> "list[bool]":
        """free[i]: device i is not quarantined and no running accelerator
        attempt holds it."""
        free = [True] * self.n_tpu_devices
        for st in self.running.values():
            if (st.state == TaskState.RUNNING and st.run_on_tpu
                    and 0 <= st.tpu_device_id < self.n_tpu_devices):
                free[st.tpu_device_id] = False
        for d in self._quarantined():
            if 0 <= d < self.n_tpu_devices:
                free[d] = False
        return free

    def _status_dict(self) -> dict:
        with self.lock:
            cpu, tpu, red = self._counts()
            total_mb = self.conf.get_int("mapred.tasktracker.memory.mb", -1)
            if total_mb >= 0:
                used = sum(t.memory_mb for aid, t in self.running_tasks.items()
                           if self.running[aid].state == TaskState.RUNNING)
                avail_mb = max(0, total_mb - used)
            else:
                avail_mb = -1
            # a quarantined card's slot is not advertised until restored
            quarantined = self._quarantined()
            return {
                "tracker_name": self.name,
                "host": self.host,
                "shuffle_addr": f"127.0.0.1:{self.shuffle_port}",
                "shuffle_port": self.shuffle_port,
                "max_cpu_map_slots": self.max_cpu_map_slots,
                "max_tpu_map_slots": max(
                    0, self.max_tpu_map_slots - len(quarantined)),
                "quarantined_tpu_devices": quarantined,
                "max_reduce_slots": self.max_reduce_slots,
                "count_cpu_map_tasks": cpu,
                "count_tpu_map_tasks": tpu,
                "count_reduce_tasks": red,
                "available_tpu_devices": self._available_tpu_devices(),
                "available_memory_mb": avail_mb,
                "task_statuses": [st.to_dict()
                                  for st in self.running.values()],
                "fetch_failures": list(self._fetch_failures),
                "healthy": (self.health.healthy
                            if self.health is not None else True),
                "health_report": (self.health.report
                                  if self.health is not None else ""),
            }

    # ------------------------------------------------------------ heartbeat

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            wait_s = self.heartbeat_s
            try:
                self._heartbeat_once()
                self.heartbeat_error = ""
            except Exception as e:  # noqa: BLE001 — the next beat retries
                err = f"{type(e).__name__}: {e}"
                if err != self.heartbeat_error:
                    _log.warning("%s: heartbeat failed: %s", self.name, err)
                self.heartbeat_error = err
                if isinstance(e, (ConnectionError, OSError, EOFError)):
                    # the master is gone in transport, not this runner's
                    # fault: kill nothing, back off with jitter so that a
                    # restarting master is not met by every runner at once
                    self._master_failures += 1
                    self.master_unreachable = True
                    backoff = min(self._lost_master_backoff_max_s,
                                  self.heartbeat_s
                                  * (2 ** min(self._master_failures, 6)))
                    wait_s = max(self.heartbeat_s,
                                 backoff * random.uniform(0.5, 1.0))
            self._stop.wait(wait_s)

    def _heartbeat_once(self) -> None:
        full = self._status_dict()
        ask = (full["count_cpu_map_tasks"] < self.max_cpu_map_slots
               or full["count_tpu_map_tasks"] < full["max_tpu_map_slots"]
               or full["count_reduce_tasks"] < self.max_reduce_slots)
        resp = self.master.call("heartbeat", full, self._initial_contact,
                                ask, self._response_id)
        # the master that answered has adopted this beat's status
        self.master_unreachable = False
        self._master_failures = 0
        self._initial_contact = False
        self._response_id = resp["response_id"]
        with self.lock:
            # the master has these reports and terminal statuses now; a
            # task that ended while the call was in flight was sent as
            # RUNNING and stays for the next beat
            del self._fetch_failures[:len(full["fetch_failures"])]
            for sd in full["task_statuses"]:
                if sd["state"] in TaskState.TERMINAL:
                    aid = sd["attempt_id"]
                    self.running.pop(aid, None)
                    self.running_tasks.pop(aid, None)
                    self._last_progress.pop(aid, None)
                    self._progress_sigs.pop(aid, None)
                    self._umb_ticks.pop(aid, None)
                    # a reaped attempt's thread may still run: its kill
                    # flag stays until the thread ends (_run_task)
                    if aid not in self._live_reporters:
                        self._kill_requested.discard(aid)
        for action in resp["actions"]:
            self._apply_action(action)
        self._beats += 1
        if self._beats % PURGE_EVERY_BEATS == 0:
            self._purge_handoffs()

    def _purge_handoffs(self) -> None:
        """Drop the served handoff copies of every upstream job whose
        pipeline has ended. A finished stage keeps serving while its
        pipeline runs, so the job's own cleanup leaves them."""
        with self.lock:
            keys = {k[0] for k in self.map_outputs
                    if k[0].startswith(SERVE_PREFIX)}
        for key in keys:
            job_id = key[len(SERVE_PREFIX):]
            try:
                if not self.master.call("handoff_purgeable", job_id):
                    continue
            except Exception:  # noqa: BLE001 — the master is briefly away:
                continue       # keep serving, ask at the next sweep
            with self.lock:
                for k in [k for k in self.map_outputs if k[0] == key]:
                    del self.map_outputs[k]
                src = self._handoff_sources.pop(job_id, None)
            if src is not None:
                src.close()
            d = os.path.join(self.local_root, "handoff", job_id)
            self._spill_fds.invalidate(d + os.sep)
            shutil.rmtree(d, ignore_errors=True)

    def _apply_action(self, action: dict) -> None:
        kind = action.get("type")
        if kind == "launch":
            self._launch(action["job_id"], Task.from_dict(action["task"]))
        elif kind == "kill_task":
            with self.lock:
                if action["attempt_id"] in self.running:
                    self._kill_requested.add(action["attempt_id"])
        elif kind == "reinit":
            # the master reset this runner: its attempts are dropped and
            # it registers again
            with self.lock:
                self.running.clear()
                self.running_tasks.clear()
                self._initial_contact = True
                self._response_id = 0
        elif kind == "recover_job":
            # a restarted master resubmitted a job under a new id: its
            # outputs here move to the new id, for reduces launched under
            # it (an adopted reduce of the old id still finds them)
            old, new = str(action["old"]), str(action["new"])
            with self.lock:
                self._job_rebinds[old] = new
                for key in [k for k in self.map_outputs if k[0] == old]:
                    self.map_outputs[(new, key[1])] = \
                        self.map_outputs.pop(key)
        elif kind == "cleanup_job":
            job_id = action["job_id"]
            with self.lock:
                new = self._job_rebinds.pop(job_id, None)
                for key in [k for k in self.map_outputs
                            if k[0] in (job_id, new)]:
                    del self.map_outputs[key]
                jc = self.job_confs.pop(job_id, None)
            if jc is not None:
                filecache.release_job(jc, os.path.join(self.local_root,
                                                       "cache"), job_id)
            d = os.path.join(self.local_root, job_id)
            self._spill_fds.invalidate(d + os.sep)
            shutil.rmtree(d, ignore_errors=True)

    # ------------------------------------------------------------ tasks

    def _job_conf(self, job_id: str) -> JobConf:
        with self.lock:
            jc = self.job_confs.get(job_id)
        if jc is None:
            jc = JobConf()
            for k, v in self.master.call("get_job_conf", job_id).items():
                jc.set(k, v)
            jc.set(DEVICE_KEY, self.device_key)   # the node's device
            jc.set("tpumr.job.id", job_id)
            jc.set("tpumr.cache.dir", os.path.join(self.local_root, "cache"))
            # a reduce's merge runs, inside the job's scratch tree so that
            # the job's cleanup removes any left behind
            jc.set("tpumr.task.local.dir",
                   os.path.join(self.local_root, job_id, "shuffle"))
            if jc.get_boolean("tpumr.pipeline.stream.handoff", False):
                # the tee outlives the job's cleanup: downstream stages
                # read it after the job ended, until the pipeline ends
                jc.set("tpumr.pipeline.handoff.dir",
                       os.path.join(self.local_root, "handoff", job_id))
            if jc.get("tpumr.pipeline.handoff.upstream"):
                jc.set("tpumr.pipeline.handoff.source", self._handoff_source)
            with self.lock:
                jc = self.job_confs.setdefault(job_id, jc)
            self._reaper_wake.set()
        return jc

    def _launch(self, job_id: str, task: Task) -> None:
        aid = str(task.attempt_id)
        status = TaskStatus(attempt_id=task.attempt_id, is_map=task.is_map,
                            state=TaskState.RUNNING,
                            phase=(TaskPhase.MAP if task.is_map
                                   else TaskPhase.SHUFFLE),
                            run_on_tpu=task.run_on_tpu,
                            tpu_device_id=task.tpu_device_id)
        t = threading.Thread(target=self._run_task,
                             args=(job_id, task, status),
                             name=f"task-{aid}", daemon=True)
        with self.lock:
            self.running[aid] = status
            self.running_tasks[aid] = task
            self._last_progress[aid] = time.monotonic()
            self._task_threads.add(t)
        t.start()

    def _run_task(self, job_id: str, task: Task, status: TaskStatus) -> None:
        aid = str(task.attempt_id)

        def on_progress(f: float) -> None:
            # never backwards: a late report must not undo the settle's 1.0
            status.progress = max(status.progress, min(1.0, float(f)))

        reporter = Reporter(abort_check=lambda: self._killed(aid),
                            on_progress=on_progress)
        with self.lock:
            self._live_reporters[aid] = reporter
        sem = (self._red_sem if not task.is_map
               else self._tpu_sem if task.run_on_tpu else self._cpu_sem)
        try:
            while not sem.acquire(timeout=0.1):
                if self._stop.is_set():
                    return
            try:
                self._run_task_inner(job_id, task, status, reporter)
            finally:
                sem.release()
        finally:
            with self.lock:
                self._task_threads.discard(threading.current_thread())
                self._live_reporters.pop(aid, None)
                if aid not in self.running:   # its end already reported
                    self._kill_requested.discard(aid)

    def _killed(self, aid: str) -> bool:
        with self.lock:
            return aid in self._kill_requested or self._stop.is_set()

    def _abort_if_settled(self, status: TaskStatus) -> None:
        """A settle guard: an attempt the reaper already failed must not
        register output or take the commit (a grant to a dead attempt
        would deny every re-run its commit)."""
        with self.lock:
            if status.state in TaskState.TERMINAL:
                raise TaskKilledError("attempt settled while still running "
                                      "(reaped for silence)")

    def _run_task_inner(self, job_id: str, task: Task, status: TaskStatus,
                        reporter: Reporter) -> None:
        aid = str(task.attempt_id)
        try:
            conf = self._job_conf(job_id)
            if self._isolate_in_process(conf, task):
                run_task_in_process(self, job_id, task, status, conf)
                return
            local_dir = os.path.join(self.local_root, job_id, aid)
            handoff = None
            if task.is_map:
                path, index = run_map_task(conf, task, local_dir, reporter)
                self._abort_if_settled(status)
                if path:
                    # stamped with the attempt that made it: the serving
                    # seams target attempt generations, and a re-run
                    # registers over the lost attempt's entry
                    index = dict(index, attempt=aid,
                                 attempt_no=task.attempt_id.attempt)
                    with self.lock:
                        self.map_outputs[(self._job_rebinds.get(
                            job_id, job_id), task.partition)] = (path, index)
            else:
                locator = self._map_locator(job_id, aid, reporter)
                try:
                    from tpumr_torch.mapred import device_shuffle
                    if device_shuffle.is_device_shuffle(conf):
                        # the gang task: every map's dense output, sorted
                        # on this runner's device
                        device_shuffle.run_device_reduce(
                            conf, task,
                            self._remote_dense_fetch_factory(job_id,
                                                             locator),
                            reporter)
                    else:
                        handoff = run_reduce_task(
                            conf, task,
                            self._remote_fetch_factory(job_id, task,
                                                       locator),
                            reporter)
                finally:
                    locator.close()
                status.phase = TaskPhase.REDUCE
                self._abort_if_settled(status)
            committed = self._commit(conf, task)
            if handoff is not None:
                self._register_handoff(job_id, task, handoff, committed)
            with self.lock:
                if status.state in TaskState.TERMINAL:
                    return   # reaped meanwhile: the late finish changes nothing
                status.counters = reporter.counters.to_dict()
                status.progress = 1.0
                status.finish_time = time.time()
                if not committed:
                    status.diagnostics = "commit denied: another attempt won"
                    status.state = TaskState.KILLED
                else:
                    status.state = (TaskState.KILLED
                                    if aid in self._kill_requested
                                    else TaskState.SUCCEEDED)
            if status.state == TaskState.SUCCEEDED:
                self._note_device_result(task, None)
        except TaskKilledError as e:
            with self.lock:
                if status.state in TaskState.TERMINAL:
                    return   # reaped: FAILED, class timeout, already
                status.diagnostics = str(e)
                status.finish_time = time.time()
                status.state = TaskState.KILLED
        except Exception as e:  # noqa: BLE001 — a failed attempt is data
            with self.lock:
                if status.state in TaskState.TERMINAL:
                    return
                status.diagnostics = (f"{type(e).__name__}: {e}\n"
                                      + traceback.format_exc(limit=8))
                status.finish_time = time.time()
                # tagged at its site (the accelerator runner) or classed
                # by the generic rule
                status.failure_class = classify_exception(e)
                status.state = TaskState.FAILED
            self._note_device_result(task, status.failure_class)

    def _isolate_in_process(self, conf: JobConf, task: Task) -> bool:
        """Whether the attempt runs in a child process:
        ``tpumr.task.isolation=process`` in the job's conf, else the
        runner's. Never an accelerator-slot attempt or a device-shuffled
        job's gang reduce (the CUDA context and the split cache are the
        runner's), nor a pipeline stage that tees its output for a stream
        handoff or reads one (the handoff's writer and source are objects
        of the runner)."""
        mode = conf.get("tpumr.task.isolation",
                        self.conf.get("tpumr.task.isolation", "thread"))
        if mode != "process" or task.run_on_tpu:
            return False
        if conf.get_boolean("tpumr.pipeline.stream.handoff", False) or \
                conf.get("tpumr.pipeline.handoff.upstream"):
            return False
        return task.is_map or not conf.device_shuffle

    def _note_child(self, attempt_id: str, pid: "int | None") -> None:
        """An isolated attempt's child started (its pid) or ended (None)."""
        with self.lock:
            if pid is None:
                self._children.pop(attempt_id, None)
            else:
                self._children[attempt_id] = pid

    def _note_device_result(self, task: Task,
                            failure_class: "str | None") -> None:
        """An accelerator map's end, counted against its card: a
        device-classed failure toward the card's quarantine, anything else
        breaking the streak."""
        if (self.device_health is None or not task.is_map
                or not task.run_on_tpu or task.tpu_device_id < 0):
            return
        dev = task.tpu_device_id % max(1, self.n_tpu_devices)
        if failure_class == FailureClass.DEVICE:
            if self.device_health.record_failure(dev):
                with self.lock:
                    self.tpu_device_quarantines += 1
        else:
            self.device_health.record_success(dev)

    def _register_handoff(self, job_id: str, task: Task, handoff: dict,
                          committed: bool) -> None:
        """Serve the tee of the attempt that won the commit; a loser's tee
        is deleted (nothing would serve or purge it)."""
        if not committed:
            try:
                os.unlink(handoff["path"])
            except OSError:
                pass
            return
        index = dict(handoff["index"], attempt=str(task.attempt_id),
                     attempt_no=task.attempt_id.attempt)
        with self.lock:
            key = serve_key(self._job_rebinds.get(job_id, job_id))
            self.map_outputs[(key, task.partition)] = (handoff["path"], index)

    def _handoff_source(self, upstream_job: str) -> HandoffSource:
        """The stream source of one upstream job, shared by every map of
        the downstream stage on this runner: a :class:`MapLocator` over
        the master's handoff feed, folded by one cursor."""
        with self.lock:
            src = self._handoff_sources.get(upstream_job)
            if src is None:
                src = self._handoff_sources[upstream_job] = \
                    make_handoff_source(
                        upstream_job,
                        lambda cursor: self.master.call(
                            "get_handoff_completion_events", upstream_job,
                            cursor),
                        poll_s=self.conf.get_int("tpumr.shuffle.poll.ms",
                                                 200) / 1000.0)
            return src

    def _map_locator(self, job_id: str, attempt_id: str,
                     reporter: Reporter) -> MapLocator:
        """A reduce attempt's locator over the job's map-completion feed;
        a blocked resolve ticks the reporter (waiting for a map's re-run is
        not a hang) and raises ``TaskKilledError`` once the attempt is
        killed or the runner stops."""
        locator = make_map_locator(
            lambda cursor: self.master.call("get_map_completion_events",
                                            job_id, cursor),
            poll_s=self.conf.get_int("tpumr.shuffle.poll.ms", 200) / 1000.0,
            timeout_s=self.conf.get_int("tpumr.shuffle.timeout.ms",
                                        600_000) / 1000.0)

        def on_wait() -> None:
            reporter.keepalive()
            if self._killed(attempt_id):
                raise TaskKilledError(f"{attempt_id} stopped while waiting "
                                      "for map outputs")

        locator.on_wait = on_wait
        return locator

    def _remote_fetch_factory(self, job_id: str, task: Task,
                              locator: MapLocator) -> RemoteChunkSource:
        """The reduce's chunk source, whose fetch failures are reported to
        the master and whose copy stops when the attempt is killed."""
        aid = str(task.attempt_id)
        src = RemoteChunkSource(self._job_conf(job_id), job_id, locator)
        src.on_fetch_failure = (
            lambda map_index, map_attempt:
            self.report_fetch_failure(aid, map_attempt))
        src.abort_check = lambda: self._killed(aid)
        return src

    @staticmethod
    def _remote_dense_fetch_factory(job_id: str, locator: MapLocator
                                    ) -> "device_shuffle.DenseFetchFn":
        """The gang reduce's fetch: each map's whole dense output. A fetch
        that fails fails the attempt (no report, as in the JAX package)."""

        def fetch(map_index: int):
            from tpumr_torch.mapred import device_shuffle
            out = locator(map_index).call("get_map_output_dense", job_id,
                                          map_index)
            return device_shuffle.parse_dense_bytes(out["data"])

        return fetch

    def _commit(self, conf: JobConf, task: Task) -> bool:
        """Promote the attempt's output files, if it wrote any, when the
        master grants the commit. False: another attempt won it."""
        if not conf.get("mapred.output.dir"):
            return True
        committer = FileOutputCommitter(conf)
        aid = str(task.attempt_id)
        if not committer.needs_commit(aid):
            return True
        if self.master.call("can_commit", str(task.task_id), aid):
            committer.commit_task(aid)
            return True
        committer.abort_task(aid)
        return False

    # ------------------------------------------------------------ reaper

    def _progress_signature(self, st: TaskStatus,
                            reporter: "Reporter | None") -> tuple:
        """What changes while an attempt makes progress: its phase and
        progress, and its reporter's status line, counter total and
        ticks."""
        with self.lock:
            umb_ticks = self._umb_ticks.get(str(st.attempt_id), 0)
        pushed = sum(v for names in (st.counters or {}).values()
                     for v in names.values())
        if reporter is None:
            return (st.phase, round(st.progress, 6), "", 0, 0, pushed,
                    umb_ticks)
        total = sum(v for names in reporter.counters.to_dict().values()
                    for v in names.values())
        return (st.phase, round(st.progress, 6), reporter.status, total,
                reporter.ticks, pushed, umb_ticks)

    def _task_timeout_s(self, aid: str) -> float:
        """The attempt's ``mapred.task.timeout``: its job's conf over the
        runner's over the default; 0 or less turns reaping off."""
        runner_ms = self.conf.get_int("mapred.task.timeout", TASK_TIMEOUT_MS)
        try:
            job_id = str(TaskAttemptID.parse(aid).task.job)
        except (ValueError, IndexError):
            return runner_ms / 1000.0
        with self.lock:
            jc = self.job_confs.get(job_id)
        if jc is None:
            return runner_ms / 1000.0
        return jc.get_int("mapred.task.timeout", runner_ms) / 1000.0

    def _reaper_wait_s(self) -> float:
        """A quarter of the smallest timeout in force (the runner's and
        every cached job's), within [0.1, 5] s."""
        smallest = self.conf.get_int("mapred.task.timeout", TASK_TIMEOUT_MS)
        with self.lock:
            confs = list(self.job_confs.values())
        for jc in confs:
            t = jc.get_int("mapred.task.timeout", smallest)
            if 0 < t < smallest or smallest <= 0 < t:
                smallest = t
        if smallest <= 0:
            return 5.0
        return max(0.1, min(5.0, smallest / 1000.0 / 4.0))

    def _reaper_loop(self) -> None:
        while not self._stop.is_set():
            self._reaper_wake.wait(self._reaper_wait_s())
            self._reaper_wake.clear()
            if self._stop.is_set():
                return
            try:
                self._reap_hung_tasks()
            except Exception:  # noqa: BLE001 — the reaper outlives any one
                _log.exception("%s: reaper pass failed", self.name)

    def _reap_hung_tasks(self) -> "list[str]":
        """One pass: note each running attempt's progress and fail those
        silent past their timeout. Returns the attempts reaped."""
        now = time.monotonic()
        with self.lock:
            snapshot = [(aid, st, self._live_reporters.get(aid))
                        for aid, st in self.running.items()
                        if st.state == TaskState.RUNNING]
        reaped = []
        for aid, st, reporter in snapshot:
            sig = self._progress_signature(st, reporter)
            with self.lock:
                if self._progress_sigs.get(aid) != sig:
                    self._progress_sigs[aid] = sig
                    self._last_progress[aid] = now
                    continue
                last = self._last_progress.setdefault(aid, now)
            timeout_s = self._task_timeout_s(aid)
            if timeout_s <= 0 or now - last <= timeout_s:
                continue
            if self._reap_one(aid, now - last, timeout_s):
                reaped.append(aid)
        return reaped

    def _reap_one(self, aid: str, silent_s: float, timeout_s: float) -> bool:
        """Fail one silent attempt, class ``timeout``, and set its kill flag:
        an isolated attempt's child is SIGKILLed with its process group at
        once (``process_runner``); a thread ends at its next poll, and one
        that cannot poll keeps running while the settle guards ignore what
        it does."""
        with self.lock:
            st = self.running.get(aid)
            if st is None or st.state in TaskState.TERMINAL:
                return False
            self._kill_requested.add(aid)
            st.diagnostics = (
                f"Task {aid} failed to report status for {silent_s:.0f} "
                f"seconds (mapred.task.timeout={int(timeout_s * 1000)} ms). "
                "Killing!")
            st.failure_class = FailureClass.TIMEOUT
            st.finish_time = time.time()
            st.state = TaskState.FAILED
            self.tasks_reaped_timeout += 1
        _log.warning("%s: %s", self.name, st.diagnostics)
        return True

    def metrics(self) -> dict:
        """The runner's fault-tolerance counts, and its live task threads
        (a reaped attempt's thread ends at its next kill poll)."""
        dh = self.device_health
        with self.lock:
            threads = sorted(t.name for t in self._task_threads
                             if t.is_alive())
            return {"tasks_reaped_timeout": self.tasks_reaped_timeout,
                    "tpu_device_quarantines": self.tpu_device_quarantines,
                    "tpu_devices_quarantined": len(self._quarantined()),
                    "tpu_device_restores": (dh.restore_events
                                            if dh is not None else 0),
                    "task_threads": threads,
                    "task_children": dict(self._children)}

    # ------------------------------------------------------------ umbilical
    # an isolated attempt's child talks to its runner only; the runner
    # proxies the commit grant and the completion feed (the reference's
    # TaskUmbilicalProtocol)

    def umbilical_ping(self, attempt_id: str) -> bool:
        """The child's kill poll: True when the runner wants it gone."""
        return self._killed(attempt_id)

    def umbilical_status(self, attempt_id: str, d: dict) -> bool:
        """The child's periodic push. The reaper reads the fields set
        here; a push whose payload never changes is no progress."""
        with self.lock:
            st = self.running.get(attempt_id)
            if st is None or st.state in TaskState.TERMINAL:
                return False
            st.phase = d.get("phase", st.phase)
            st.progress = max(st.progress, float(d.get("progress", 0.0)))
            if d.get("counters"):
                st.counters = d["counters"]
            if "ticks" in d:
                self._umb_ticks[attempt_id] = int(d["ticks"])
            return True

    def umbilical_can_commit(self, task_id: str, attempt_id: str) -> bool:
        """The master's commit grant, for an attempt of that very task (a
        grant seeded for another task would deny that task's attempts)."""
        if str(TaskID.parse(task_id)) != str(
                TaskAttemptID.parse(attempt_id).task):
            raise PermissionError(
                f"task {task_id} does not belong to attempt {attempt_id}")
        return bool(self.master.call("can_commit", task_id, attempt_id))

    def umbilical_events(self, job_id: str, cursor: int) -> list:
        """The master's map-completion feed, for an isolated reduce."""
        return self.master.call("get_map_completion_events", job_id, cursor)

    def umbilical_done(self, attempt_id: str, final: dict, job_id: str,
                       partition: int, out_path: str, index: dict) -> None:
        """The child's end: settle its status and, for a map that
        succeeded, serve its output, which must lie under the runner's
        local root. An attempt already settled (reaped) stays as it is and
        serves nothing."""
        attempt = TaskAttemptID.parse(attempt_id)
        if str(attempt.task.job) != job_id:
            raise PermissionError(
                f"attempt {attempt_id} does not belong to job {job_id}")
        with self.lock:
            st = self.running.get(attempt_id)
            if st is None or st.state in TaskState.TERMINAL:
                return
            st.counters = final.get("counters", {})
            st.progress = float(final.get("progress", 1.0))
            st.phase = final.get("phase", st.phase)
            st.diagnostics = final.get("diagnostics", "")
            st.finish_time = time.time()
            st.state = final.get("state", TaskState.SUCCEEDED)
            if not out_path or st.state != TaskState.SUCCEEDED:
                return
            real = os.path.realpath(out_path)
            if not real.startswith(os.path.realpath(self.local_root)
                                   + os.sep):
                raise PermissionError(f"{out_path} is not under the "
                                      "runner's local directory")
            self.map_outputs[(self._job_rebinds.get(job_id, job_id),
                              int(partition))] = (
                real, dict(index, attempt=attempt_id,
                           attempt_no=attempt.attempt))

    def umbilical_fail(self, attempt_id: str, state: str, diagnostics: str,
                       failure_class: str = "") -> None:
        """The child failed or was killed; ``failure_class`` is the child's
        classification, which reaches the master as an attempt in a thread
        would."""
        with self.lock:
            st = self.running.get(attempt_id)
            if st is None or st.state in TaskState.TERMINAL:
                return
            st.diagnostics = diagnostics
            st.finish_time = time.time()
            st.failure_class = str(failure_class or "")
            st.state = (state if state in TaskState.TERMINAL
                        else TaskState.FAILED)

    def umbilical_report_fetch_failure(self, reduce_attempt: str,
                                       map_attempt: str) -> None:
        """An isolated reduce could not fetch ``map_attempt``'s output: as
        :meth:`report_fetch_failure`, for a map of the reduce's own job."""
        reduce_job = str(TaskAttemptID.parse(reduce_attempt).task.job)
        if map_attempt and str(
                TaskAttemptID.parse(map_attempt).task.job) != reduce_job:
            raise PermissionError(f"map attempt {map_attempt} is not of "
                                  f"{reduce_attempt}'s job")
        self.report_fetch_failure(reduce_attempt, map_attempt)

    # ------------------------------------------------------------ shuffle

    def report_fetch_failure(self, reduce_attempt: str,
                             map_attempt: str) -> None:
        """A reduce here could not fetch ``map_attempt``'s output: the
        report goes with the next heartbeat; the master counts reducers
        and re-executes the map, while the reduce waits for the re-run."""
        if not map_attempt:
            return   # never resolved: nothing to name
        with self.lock:
            self._fetch_failures.append({"reduce_attempt": reduce_attempt,
                                         "map_attempt": map_attempt})

    def _maybe_fail_serve(self, job_id: str, map_index: int,
                          index: dict) -> None:
        """The serving side's fault seams, on the job's conf:
        ``shuffle.serve``, ``shuffle.serve.m<i>`` (one map's output) and
        ``shuffle.serve.a<n>`` (an attempt generation:
        ``tpumr.fi.shuffle.serve.a0.probability=1`` makes every map's first
        output unfetchable while its re-run serves)."""
        with self.lock:
            conf = self.job_confs.get(job_id)
        conf = conf if conf is not None else self.conf
        maybe_fail("shuffle.serve", conf)
        maybe_fail(f"shuffle.serve.m{map_index}", conf)
        attempt_no = index.get("attempt_no")
        if attempt_no is not None:
            maybe_fail(f"shuffle.serve.a{attempt_no}", conf)

    def _map_output_entry(self, job_id: str,
                          map_index: int) -> "tuple | None":
        """A served output by the job id asked for, or through a restart's
        rebinding either way: outputs move to the new id, while a reduce
        adopted across the restart asks with the old one. A handoff key
        (``handoff:<job>``) follows the rebinding of its job."""
        rebind = job_id
        if job_id.startswith(SERVE_PREFIX):
            inner = self._job_rebinds.get(job_id[len(SERVE_PREFIX):])
            if inner is not None:
                rebind = SERVE_PREFIX + inner
        with self.lock:
            ent = self.map_outputs.get((job_id, map_index))
            if ent is None and rebind != job_id:
                ent = self.map_outputs.get((rebind, map_index))
            if ent is None:
                new = self._job_rebinds.get(job_id)
                if new is not None:
                    ent = self.map_outputs.get((new, map_index))
        return ent

    def _entry(self, job_id: str, map_index: int, dense: bool
               ) -> "tuple[str, dict]":
        """(path, index) of a served output of the kind asked for, past
        the serving seams."""
        ent = self._map_output_entry(job_id, int(map_index))
        if ent is None:
            raise KeyError(f"no map output for {job_id} map {map_index}")
        path, index = ent
        if not dense:
            self._maybe_fail_serve(job_id, map_index, index)
        if bool(index.get("dense")) != dense:
            raise ValueError(
                f"map output for {job_id} map {map_index} is "
                + ("not dense: fetch with get_map_output" if dense else
                   "dense (device-shuffled job): fetch with "
                   "get_map_output_dense"))
        return path, index

    def get_map_output(self, job_id: str, map_index: int,
                       partition: int) -> dict:
        """One partition's segment of a map's IFile, as it lies on disk."""
        path, index = self._entry(job_id, map_index, dense=False)
        with open(path, "rb") as f:
            data = ifile.partition_bytes(f, index, int(partition))
        return {"data": data, "codec": index.get("codec", "none")}

    #: the most one chunk response carries, whatever the client asks
    MAX_CHUNK_BYTES = 4 << 20

    def get_map_output_chunk(self, job_id: str, map_index: int,
                             partition: int, offset: int, max_bytes: int,
                             wire: str = "none") -> dict:
        """A bounded range of one partition's payload (:func:`serve_chunk`):
        ``offset`` is payload-relative, ``total`` the payload's length and
        ``raw`` its decompressed length, which the reduce's RAM budget
        weighs; ``wire`` names a codec the client decodes."""
        path, index = self._entry(job_id, map_index, dense=False)
        return serve_chunk(self._spill_fds, path, index, int(partition),
                           offset, max_bytes, self.MAX_CHUNK_BYTES, wire)

    def get_map_output_dense(self, job_id: str, map_index: int) -> dict:
        """A device-shuffled map's dense output file, whole and as it is."""
        path, _index = self._entry(job_id, map_index, dense=True)
        with open(path, "rb") as f:
            return {"data": f.read()}
