"""Node self-checks: the health script, the task memory manager and the
per-device accelerator quarantine.

Counterpart of ``tpumr/mapred/node_health.py``, all three parts:

- :class:`NodeHealthChecker` runs ``mapred.healthChecker.script.path``
  every ``mapred.healthChecker.interval.ms``; a line of its output that
  starts with ``ERROR`` marks the node unhealthy, and the master gives an
  unhealthy node runner no task. A script that times out is unhealthy; one
  that cannot run, or exits non-zero without an ``ERROR`` line, is not.
- :class:`TaskMemoryManager` kills a registered child process whose RSS
  (``/proc/<pid>/status``) exceeds the limit it was registered with,
  ``mapred.task.limit.maxrss.mb``. The node's one manager,
  :data:`GLOBAL_MEMORY_MANAGER`, watches the children the node starts: the
  process-isolated attempts (``mapred/process_runner.py``) and the pipes
  children (``pipes/application.py``). Its sampling thread starts at the
  first registration and ends by itself one interval after the last child
  is unregistered, so a node with no child to watch runs no thread.
- :class:`TpuDeviceHealth`: ``threshold`` consecutive device-classed
  failures on a card quarantine it, and its node runner advertises one
  accelerator slot fewer until a probe passes again. The probe runs on the
  health object's own thread, on a backoff from ``probe_interval_s`` that
  doubles up to ``probe_max_interval_s``. A success between failures
  breaks the streak.

The probe on the card (:func:`default_tpu_probe`) puts eight floats on
``cuda:<id>`` and synchronises. Two things follow from running it in the
node runner's process:

- A probe that never returns (a hung card) holds only the probe thread:
  the heartbeat reads the quarantine under a lock the probe never takes,
  so the node goes on reporting, with the card still out.
  :meth:`TpuDeviceHealth.stop` waits for the thread a bounded time.
- A sticky CUDA error (an illegal address, a device-side assert) poisons
  the process's CUDA context: every later CUDA call fails, the probe's
  too, so the card stays quarantined until the process restarts. That is
  the right outcome: nothing in that process can use the card again.
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Any, Callable

#: seconds ``stop`` waits for a checker's thread
JOIN_TIMEOUT_S = 5.0


class NodeHealthChecker:
    """The operator's health script, run now and every ``interval_s``."""

    def __init__(self, script: str, interval_s: float = 10.0,
                 timeout_s: float = 30.0) -> None:
        self.script = script
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.healthy = True
        self.report = ""
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def check_once(self) -> None:
        try:
            proc = subprocess.run(["/bin/sh", "-c", self.script],
                                  capture_output=True, text=True,
                                  timeout=self.timeout_s)
            out = (proc.stdout or "").strip()
            # a non-zero exit alone is not unhealthy: a broken script must
            # not take nodes out
            bad = [ln for ln in out.splitlines() if ln.startswith("ERROR")]
            self.healthy = not bad
            self.report = "; ".join(bad)
        except subprocess.TimeoutExpired:
            self.healthy = False
            self.report = "health script timed out"
        except Exception as e:  # noqa: BLE001 — a script that cannot run
            self.healthy = True   # says nothing of the node
            self.report = f"health script error: {e}"

    def start(self) -> "NodeHealthChecker":
        if self._thread is None:
            self.check_once()
            self._thread = threading.Thread(target=self._loop,
                                            name="node-health", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(JOIN_TIMEOUT_S)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_once()


def process_rss_bytes(pid: int) -> "int | None":
    """VmRSS of one process, from ``/proc`` (Linux); None if unreadable."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return None
    return None


class TaskMemoryManager:
    """Samples the registered task processes every ``interval_s`` and kills
    those above their limit through their callback."""

    def __init__(self, interval_s: float = 1.0) -> None:
        self.interval_s = interval_s
        self._lock = threading.Lock()
        #: attempt id -> (pid, limit bytes, kill callback)
        self._tasks: "dict[str, tuple[int, int, Callable[[str], None]]]" = {}
        self.killed: "list[str]" = []
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        #: the last sampler that ended for want of children, which
        #: :meth:`stop` still joins
        self._idle_thread: "threading.Thread | None" = None

    def register(self, attempt_id: str, pid: int, limit_bytes: int,
                 kill_cb: Callable[[str], None]) -> None:
        with self._lock:
            self._tasks[attempt_id] = (pid, limit_bytes, kill_cb)
        # a limit set in a job's conf is enforced even where the runner's
        # conf never started the sampler
        self.start()

    def watching(self) -> "list[str]":
        with self._lock:
            return sorted(self._tasks)

    def unregister(self, attempt_id: str) -> None:
        with self._lock:
            self._tasks.pop(attempt_id, None)

    def check_once(self) -> "list[str]":
        with self._lock:
            tasks = list(self._tasks.items())
        over = []
        for aid, (pid, limit, kill_cb) in tasks:
            rss = process_rss_bytes(pid)
            if rss is not None and limit > 0 and rss > limit:
                over.append(aid)
                self.killed.append(aid)
                try:
                    kill_cb(aid)
                except Exception:  # noqa: BLE001 — the next sample retries
                    pass
                self.unregister(aid)
        return over

    def start(self) -> "TaskMemoryManager":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="task-memory", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop sampling and wait for the thread; :meth:`start` may start
        it again."""
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
            idle, self._idle_thread = self._idle_thread, None
        for t in (thread, idle):
            if t is not None:
                t.join(JOIN_TIMEOUT_S)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_once()
            with self._lock:
                # nothing left to watch: end; the next register starts a
                # thread again
                if not self._tasks and \
                        self._thread is threading.current_thread():
                    self._thread = None
                    self._idle_thread = threading.current_thread()
                    return


#: the node's manager: every child a node runner or a pipes task starts
GLOBAL_MEMORY_MANAGER = TaskMemoryManager()


def default_tpu_probe(device_id: int) -> None:
    """A card's liveness: eight floats on ``cuda:<device_id>``, then a
    synchronise. Raises where the card, or the CUDA context, is sick."""
    import torch
    torch.ones(8, device=f"cuda:{device_id}")
    torch.cuda.synchronize(device_id)


def cpu_probe(device_id: int) -> None:
    """The probe of a runner whose accelerator slots run on the CPU."""
    import torch
    torch.ones(8).sum().item()


class TpuDeviceHealth:
    """Per-card quarantine: ``threshold`` consecutive device-classed
    failures on a card (0 turns it off) take it out; a probe on a capped
    exponential backoff brings it back at its first success."""

    def __init__(self, n_devices: int, threshold: int = 3,
                 probe: "Callable[[int], Any] | None" = None,
                 probe_interval_s: float = 10.0,
                 probe_max_interval_s: float = 300.0) -> None:
        self.n_devices = max(0, n_devices)
        self.threshold = threshold
        self.probe = probe if probe is not None else default_tpu_probe
        self.probe_interval_s = max(0.05, probe_interval_s)
        self.probe_max_interval_s = max(self.probe_interval_s,
                                        probe_max_interval_s)
        self._lock = threading.Lock()
        self._consecutive: "dict[int, int]" = {}
        #: device -> (next probe, monotonic; current backoff, s)
        self._quarantined: "dict[int, tuple[float, float]]" = {}
        #: quarantines entered, and lifted by a probe
        self.quarantine_events = 0
        self.restore_events = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: "threading.Thread | None" = None

    def record_failure(self, device_id: int) -> bool:
        """One device-classed failure on ``device_id``; True when it newly
        quarantined the card."""
        if not 0 <= device_id < self.n_devices or self.threshold <= 0:
            return False
        with self._lock:
            if device_id in self._quarantined:
                return False
            n = self._consecutive.get(device_id, 0) + 1
            self._consecutive[device_id] = n
            if n < self.threshold:
                return False
            self._quarantined[device_id] = (
                time.monotonic() + self.probe_interval_s,
                self.probe_interval_s)
            self._consecutive.pop(device_id, None)
            self.quarantine_events += 1
        self._ensure_thread()
        self._wake.set()
        return True

    def record_success(self, device_id: int) -> None:
        """An attempt ended well on the card: the streak is broken."""
        with self._lock:
            self._consecutive.pop(device_id, None)

    def quarantined(self) -> "list[int]":
        with self._lock:
            return sorted(self._quarantined)

    def is_quarantined(self, device_id: int) -> bool:
        with self._lock:
            return device_id in self._quarantined

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is not None or self._stop.is_set():
                return
            self._thread = threading.Thread(target=self._probe_loop,
                                            name="tpu-device-probe",
                                            daemon=True)
        self._thread.start()

    def probe_once(self, now: "float | None" = None) -> "list[int]":
        """Probe each quarantined card whose time has come, outside the
        lock; restore those that pass, back the others off. Returns the
        restored ids (the seam tests drive instead of the thread)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            due = [d for d, (at, _b) in self._quarantined.items()
                   if at <= now]
        restored = []
        for d in due:
            try:
                self.probe(d)
            except Exception:  # noqa: BLE001 — still sick: back off
                with self._lock:
                    if d in self._quarantined:
                        _at, backoff = self._quarantined[d]
                        backoff = min(backoff * 2, self.probe_max_interval_s)
                        self._quarantined[d] = (now + backoff, backoff)
                continue
            with self._lock:
                if self._quarantined.pop(d, None) is not None:
                    self.restore_events += 1
                    restored.append(d)
        return restored

    def _next_deadline(self) -> "float | None":
        with self._lock:
            if not self._quarantined:
                return None
            return min(at for at, _b in self._quarantined.values())

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            deadline = self._next_deadline()
            if deadline is None:
                self._wake.wait(self.probe_max_interval_s)
                self._wake.clear()
                continue
            delay = max(0.0, deadline - time.monotonic())
            if delay:
                if self._stop.wait(min(delay, 1.0)):
                    return
                continue
            self.probe_once()

    def stop(self) -> None:
        """Stop probing and wait a bounded time for the probe thread (a
        probe that never returns leaves it behind, a daemon thread)."""
        self._stop.set()
        self._wake.set()
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(JOIN_TIMEOUT_S)
