"""The main of a process-isolated task attempt.

Counterpart of ``tpumr/mapred/child.py`` (the reference's ``Child.java``):
one OS process per attempt, started by ``mapred/process_runner.py`` for a
CPU-slot attempt of a job with ``tpumr.task.isolation=process``. It reads
its 0600 task file (the job's conf, the task, the node runner's address),
runs the map or the reduce, and talks to its node runner only, over the
umbilical RPC (the reference's ``TaskUmbilicalProtocol``):

- ``umbilical_ping`` every half second at the most, from the reporter's
  kill check: True ends the attempt (``TaskKilledError``), as does a runner
  that no longer answers;
- ``umbilical_status`` every second from a thread: phase, progress,
  counters, status line and the reporter's ticks, which the runner's
  reaper reads (a push whose payload never changes is no progress);
- ``umbilical_can_commit`` before the output is promoted;
- ``umbilical_events`` for a reduce's map locator, and
  ``umbilical_report_fetch_failure`` for each map output it could not
  fetch;
- ``umbilical_done`` or ``umbilical_fail`` at the end, the failure with its
  class (``task.classify_exception``), so the master sees an isolated
  attempt as it sees one in a thread.

A child that dies without reporting (a crash, ``os._exit``, a SIGKILL) is
settled by its runner from the exit code. Left out: the tracing spans and
``maybe_profile``, since the port has neither ``core/tracing.py`` nor
``mapred/profiler.py``; and the per-job token, since the port's RPC has no
authentication yet (``ROADMAP.md``): the umbilical is unauthenticated.

A CPU attempt never touches ``torch.cuda``: the task path imports torch
only for a kernel mapper's host twin, and no CUDA context opens in a child.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Callable

#: seconds between two kill polls and between two status pushes
PING_INTERVAL_S = 0.5
STATUS_INTERVAL_S = 1.0


class _Umbilical:
    """The child's end: a rate-limited kill poll and the status push."""

    def __init__(self, client: Any, aid: str) -> None:
        self.client = client
        self.aid = aid
        self._last_ping = 0.0
        self._killed = False

    def kill_requested(self) -> bool:
        if self._killed:
            return True
        now = time.monotonic()
        if now - self._last_ping >= PING_INTERVAL_S:
            self._last_ping = now
            try:
                self._killed = bool(self.client.call("umbilical_ping",
                                                     self.aid))
            except Exception:  # noqa: BLE001 — the runner is gone: stop
                self._killed = True
        return self._killed

    def push_status(self, reporter: Any, phase: str,
                    progress: float) -> None:
        try:
            self.client.call("umbilical_status", self.aid, {
                "phase": phase, "progress": progress,
                "counters": reporter.counters.to_dict(),
                "status": reporter.status, "ticks": reporter.ticks})
        except Exception:  # noqa: BLE001 — the next push tries again
            pass


def run_child(task_file: str) -> int:
    """Run the attempt that ``task_file`` describes; the exit code."""
    from tpumr_torch.io.writable import deserialize
    from tpumr_torch.ipc.rpc import RpcClient
    from tpumr_torch.mapred.api import Reporter, TaskKilledError
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.task import Task, classify_exception

    with open(task_file, "rb") as f:
        spec = deserialize(f.read())
    conf = JobConf()
    for k, v in spec["conf"].items():
        conf.set(k, v)
    task = Task.from_dict(spec["task"])
    job_id = spec["job_id"]
    aid = str(task.attempt_id)
    local_dir = os.path.dirname(os.path.abspath(task_file))

    tracker = RpcClient(spec["tracker_host"], spec["tracker_port"])
    umb = _Umbilical(tracker, aid)
    phase = ["MAP" if task.is_map else "SHUFFLE"]
    progress = [0.0]
    reporter = Reporter(abort_check=umb.kill_requested,
                        on_progress=lambda f: progress.__setitem__(0, f))
    stop = threading.Event()

    def status_loop() -> None:
        while not stop.wait(STATUS_INTERVAL_S):
            umb.push_status(reporter, phase[0], progress[0])

    pusher = threading.Thread(target=status_loop, daemon=True,
                              name="umbilical-status")
    pusher.start()

    def can_commit() -> bool:
        return bool(tracker.call("umbilical_can_commit", str(task.task_id),
                                 aid))

    try:
        out_path, index = "", {}
        if task.is_map:
            from tpumr_torch.mapred.map_task import run_map_task
            out_path, index = run_map_task(conf, task, local_dir, reporter)
        else:
            _run_reduce(conf, task, job_id, local_dir, tracker, umb,
                        reporter)
            phase[0] = "REDUCE"
        committed = _commit(conf, task, can_commit)
        stop.set()
        pusher.join(STATUS_INTERVAL_S * 2)
        tracker.call("umbilical_done", aid, {
            "counters": reporter.counters.to_dict(), "progress": 1.0,
            "phase": phase[0],
            "state": "SUCCEEDED" if committed else "KILLED",
            "diagnostics": ("" if committed
                            else "commit denied: another attempt won"),
        }, job_id, task.partition, out_path, index)
        return 0
    except TaskKilledError:
        stop.set()
        _report_fail(tracker, aid, "KILLED", "attempt killed while running "
                     "(preempted, superseded or reaped)")
        return 0
    except Exception as e:  # noqa: BLE001 — a failed attempt is data
        stop.set()
        diag = f"{type(e).__name__}: {e}\n" + traceback.format_exc(limit=8)
        _report_fail(tracker, aid, "FAILED", diag, classify_exception(e))
        return 1
    finally:
        stop.set()
        tracker.close()


def _run_reduce(conf: Any, task: Any, job_id: str, local_dir: str,
                tracker: Any, umb: _Umbilical, reporter: Any) -> None:
    """A reduce over its node runner's proxy of the master's completion
    feed; each output it could not fetch is reported up the umbilical."""
    from tpumr_torch.mapred.api import TaskKilledError
    from tpumr_torch.mapred.reduce_task import run_reduce_task
    from tpumr_torch.mapred.shuffle_copier import RemoteChunkSource
    from tpumr_torch.mapred.tasktracker import make_map_locator

    aid = str(task.attempt_id)
    locator = make_map_locator(
        lambda cursor: tracker.call("umbilical_events", job_id, cursor),
        poll_s=conf.get_int("tpumr.shuffle.poll.ms", 200) / 1000.0,
        timeout_s=conf.get_int("tpumr.shuffle.timeout.ms",
                               600_000) / 1000.0)

    def on_wait() -> None:
        reporter.keepalive()
        if umb.kill_requested():
            raise TaskKilledError(f"{aid} stopped while waiting for map "
                                  "outputs")

    locator.on_wait = on_wait
    conf.set("tpumr.task.local.dir", os.path.join(local_dir, "shuffle"))
    src = RemoteChunkSource(conf, job_id, locator)

    def report_fetch_failure(_map_index: int, map_attempt: str) -> None:
        # best effort: the copier's penalty box keeps the reduce going
        # when the report cannot be delivered
        try:
            tracker.call("umbilical_report_fetch_failure", aid, map_attempt)
        except Exception:  # noqa: BLE001
            pass

    src.on_fetch_failure = report_fetch_failure
    src.abort_check = umb.kill_requested
    try:
        run_reduce_task(conf, task, src, reporter)
    finally:
        locator.close()


def _commit(conf: Any, task: Any, can_commit: Callable[[], bool]) -> bool:
    """The commit gate, as the node runner's ``_commit``: the runner
    proxies the master's grant; a losing attempt aborts its work dir."""
    from tpumr_torch.mapred.output_formats import FileOutputCommitter
    if not conf.get("mapred.output.dir"):
        return True
    committer = FileOutputCommitter(conf)
    aid = str(task.attempt_id)
    if not committer.needs_commit(aid):
        return True
    if can_commit():
        committer.commit_task(aid)
        return True
    committer.abort_task(aid)
    return False


def _report_fail(tracker: Any, aid: str, state: str, diag: str,
                 failure_class: str = "") -> None:
    try:
        tracker.call("umbilical_fail", aid, state, diag, failure_class)
    except Exception:  # noqa: BLE001 — the runner settles by exit code
        pass


def main(argv: "list[str] | None" = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m tpumr_torch.mapred.child <task-file>",
              file=sys.stderr)
        return 2
    return run_child(argv[0])


if __name__ == "__main__":
    sys.exit(main())
