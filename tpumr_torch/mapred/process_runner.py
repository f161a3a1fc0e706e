"""Process-isolated task attempts, the node runner's side.

Counterpart of ``tpumr/mapred/process_runner.py`` (the reference's
``TaskRunner``, ``JvmManager`` and ``TaskController``). With
``tpumr.task.isolation=process`` (the job's conf first, then the runner's;
``NodeRunner._isolate_in_process``) a CPU-slot attempt runs in a child
process (``mapred/child.py``), so a crash, an ``os._exit`` or a runaway
allocation costs one attempt and not the node runner.
:func:`run_task_in_process`:

- writes the task file, 0600, into the attempt's directory under the
  runner's local root (the directory the runner serves the map's output
  from): the job's conf, the task, and the runner's umbilical address. The
  port's RPC has no authentication yet (``ROADMAP.md``), so the file holds
  no per-job token and the umbilical is open; the JAX package's token and
  its scope wait for the security slice, and so does
  ``tpumr.task.strip.cluster.secret`` (the port has no cluster secret);
- starts ``python child_boot.py task.bin`` (:func:`build_child_command`):
  a bootstrap with the runner's ``sys.path`` written in, since a
  task-controller clears the environment (``PYTHONPATH`` too) before it
  execs. The task-controller prefix (``mapred.task.tracker.task-controller``,
  ``tpumr.task.user``) comes from the runner's conf, never the job's;
- sends the child's stdout and stderr to
  ``<local root>/userlogs/<job>/<attempt>/child.log``, which outlives the
  job's scratch directory (serving and purging userlogs are not ported);
- registers the child with the node's memory manager
  (``node_health.GLOBAL_MEMORY_MANAGER``) at ``mapred.task.limit.maxrss.mb``:
  over it the child's process group is killed and the attempt fails
  classed ``oom``;
- polls the runner's kill flag (a kill action, or the reaper) and
  SIGKILLs the child's process group (:func:`_kill_tree`: the child is a
  session leader, so pipes grandchildren die with it);
- settles an attempt whose child died without reporting over the
  umbilical: ``oom`` after a memory kill or a SIGKILL it did not send,
  KILLED after a kill it asked for, else FAILED classed ``user`` with the
  log's tail. An attempt already terminal (reaped) keeps its status.

The child is started with ``subprocess.Popen`` (fork and exec), never a
``multiprocessing`` fork of a runner whose threads may hold a CUDA context.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Any

from tpumr_torch.io.writable import serialize
from tpumr_torch.mapred.task import FailureClass, Task, TaskState, TaskStatus

#: seconds between two looks at the kill flag
POLL_S = 0.05
#: seconds a killed child has to be reaped
REAP_TIMEOUT_S = 30.0

_BOOT_TEMPLATE = """\
import sys
sys.path[:0] = {path!r}
from tpumr_torch.mapred.child import main
sys.exit(main([{task_file!r}]))
"""


def build_child_command(runner: Any, task_dir: str, task_file: str,
                        log_path: str) -> "list[str]":
    """The child's argv, through the task-controller where the runner's
    conf names one (the job's conf never picks the launcher)."""
    boot = os.path.join(task_dir, "child_boot.py")
    with open(boot, "w", encoding="utf-8") as f:
        f.write(_BOOT_TEMPLATE.format(path=list(sys.path),
                                      task_file=task_file))
    cmd = [sys.executable, boot]
    tc = runner.conf.get("mapred.task.tracker.task-controller")
    if tc:
        import getpass
        user = runner.conf.get("tpumr.task.user") or getpass.getuser()
        cmd = [tc, user, task_dir, log_path] + cmd
    return cmd


def run_task_in_process(runner: Any, job_id: str, task: Task,
                        status: TaskStatus, conf: Any) -> None:
    """Start and watch one isolated attempt until its child exits; the
    child reports its own end over the umbilical, and this settles the
    attempt only where it did not."""
    aid = str(task.attempt_id)
    task_dir = os.path.join(runner.local_root, job_id, aid)
    os.makedirs(task_dir, exist_ok=True)
    task_file = os.path.join(task_dir, "task.bin")
    payload = serialize({
        "job_id": job_id, "task": task.to_dict(), "conf": dict(conf),
        "tracker_host": "127.0.0.1", "tracker_port": runner.shuffle_port})
    fd = os.open(task_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(payload)

    logs_dir = os.path.join(runner.local_root, "userlogs", job_id, aid)
    os.makedirs(logs_dir, exist_ok=True)
    log_path = os.path.join(logs_dir, "child.log")
    cmd = build_child_command(runner, task_dir, task_file, log_path)
    open(log_path, "ab").close()
    _prepare_sandbox_for_user(runner, task_dir, logs_dir)

    mem_killed: "list[str]" = []
    with open(log_path, "ab") as log_f:
        proc = subprocess.Popen(cmd, cwd=task_dir, stdin=subprocess.DEVNULL,
                                stdout=log_f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    runner._note_child(aid, proc.pid)
    limit_mb = conf.get_int("mapred.task.limit.maxrss.mb", 0)
    manager = None
    if limit_mb > 0:
        from tpumr_torch.mapred.node_health import GLOBAL_MEMORY_MANAGER
        manager = GLOBAL_MEMORY_MANAGER

        def mem_kill(_aid: str) -> None:
            mem_killed.append(_aid)
            _kill_tree(proc)

        manager.register(aid, proc.pid, limit_mb << 20, mem_kill)
    try:
        while proc.poll() is None:
            if runner._killed(aid):
                _kill_tree(proc)
                break
            time.sleep(POLL_S)
        try:
            proc.wait(timeout=REAP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            _kill_tree(proc)
            proc.wait(timeout=REAP_TIMEOUT_S)
    finally:
        if manager is not None:
            manager.unregister(aid)
        runner._note_child(aid, None)

    with runner.lock:
        if status.state in TaskState.TERMINAL:
            return
        status.finish_time = time.time()
        if mem_killed:
            status.state = TaskState.FAILED
            status.failure_class = FailureClass.OOM
            status.diagnostics = (
                f"killed by the memory manager: RSS over {limit_mb} MB "
                "(mapred.task.limit.maxrss.mb)")
        elif runner._killed(aid):
            status.state = TaskState.KILLED
            status.diagnostics = "child killed at the runner's request"
        else:
            status.state = TaskState.FAILED
            # a SIGKILL nobody here sent: most likely the kernel's OOM killer
            status.failure_class = (FailureClass.OOM
                                    if proc.returncode == -signal.SIGKILL
                                    else FailureClass.USER)
            status.diagnostics = (f"child exited rc={proc.returncode} "
                                  "without reporting\n" + _tail(log_path))


def _prepare_sandbox_for_user(runner: Any, task_dir: str,
                              logs_dir: str) -> None:
    """Launching through the task-controller as root: hand the attempt's
    directory and its userlogs directory to the task user (the controller
    refuses a task directory that user does not own), and open their
    parents for traversal only."""
    tc = runner.conf.get("mapred.task.tracker.task-controller")
    if not tc or os.geteuid() != 0:
        return
    import getpass
    import pwd
    user = runner.conf.get("tpumr.task.user") or getpass.getuser()
    try:
        pw = pwd.getpwnam(user)
    except KeyError:
        return
    if pw.pw_uid == os.geteuid():
        return
    os.chmod(runner.local_root, 0o711)
    os.chmod(os.path.dirname(task_dir), 0o711)
    os.chmod(os.path.dirname(logs_dir), 0o711)                 # userlogs/<job>
    os.chmod(os.path.dirname(os.path.dirname(logs_dir)), 0o711)  # userlogs
    for top in (task_dir, logs_dir):
        for root, _dirs, files in os.walk(top):
            os.chown(root, pw.pw_uid, pw.pw_gid)
            for name in files:
                os.chown(os.path.join(root, name), pw.pw_uid, pw.pw_gid)


def _kill_tree(proc: "subprocess.Popen[bytes]") -> None:
    """SIGKILL the child's process group: the child leads its own session,
    so its pipes children go with it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        try:
            proc.kill()
        except OSError:
            pass


def _tail(path: str, max_bytes: int = 4096) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - max_bytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""
