"""The node runner: CPU, accelerator and reduce slots on one host, a
heartbeat to the job master, task threads, and the shuffle server.

Counterpart of ``NodeRunner`` in ``tpumr/mapred/tasktracker.py``:

- slots: ``mapred.tasktracker.map.cpu.tasks.maximum``,
  ``mapred.tasktracker.map.tpu.tasks.maximum`` (accelerator map slots) and
  ``mapred.tasktracker.reduce.tasks.maximum``, each a semaphore;
- the status of every heartbeat (``:913`` there): the slots, the running
  count of each pool, the free device ids (``available_tpu_devices``,
  derived from the running accelerator attempts), the host and every
  attempt's :class:`TaskStatus`; the runner asks for work when any pool
  has room;
- the heartbeat loop (``:965-1144``): every
  ``tpumr.heartbeat.interval.ms``, the first beat marked as the initial
  contact, the master's response id echoed back; terminal statuses are
  dropped once a response arrived, and the response's actions applied
  (:meth:`NodeRunner._apply_action`: launch, kill, job cleanup); a beat
  that fails is retried at the next interval, its error kept on
  :attr:`NodeRunner.heartbeat_error` and logged once per distinct error;
- a thread per attempt (``_launch``, ``_run_task_inner``, ``:1572-1697``):
  a map runs the port's ``map_task.run_map_task``, whose ``task.run_on_tpu``
  picks ``GpuMapRunner`` (the card ``cuda:tpu_device_id``) or the CPU
  slot's runner, and registers its IFile for the shuffle; a reduce runs
  ``reduce_task.run_reduce_task`` over a
  ``shuffle_copier.RemoteSegmentSource``; output is committed through the
  master's ``can_commit``. An exception fails the attempt, and its type,
  message and traceback reach the master as the status's diagnostics;
- :meth:`NodeRunner.get_map_output` (``:2139-2162``): one partition's bytes
  of a map's IFile, served over RPC with the codec of the map output, by
  which the reduce decodes them; a reduce's merge runs go under
  ``tpumr.task.local.dir``, the job's ``shuffle`` directory (``:1364``);
- the pipeline handoff: a streaming stage's reduces tee their output under
  the runner's ``handoff`` directory, outside the job's scratch tree
  (``:1371-1391``); only the attempt that won the commit registers its tee
  for serving, under ``handoff:<job>`` (``:1615-1657``); a downstream
  stage's maps get :meth:`NodeRunner._handoff_source` through the conf
  (``:2247``); every ``PURGE_EVERY_BEATS`` heartbeats the runner drops the
  handoff entries whose pipeline has ended, as the master's
  ``handoff_purgeable`` says (``:1147-1177``).

The node decides its device: ``tpumr_torch.device`` of the runner's conf,
``cuda`` by default, is set on every job conf it runs, so a job cannot move
its accelerator-slot maps elsewhere. A runner with accelerator slots and no
CUDA raises at construction unless the conf asks for the CPU. It has
``torch.cuda.device_count()`` devices on ``cuda`` unless told how many
(``n_tpu_devices``), and ``n_tpu_devices`` or 1 on the CPU, where its
accelerator-slot maps take the kernels' plain torch versions.

Left out (``ROADMAP.md``): process isolation, the hung-task reaper,
userlogs, profiles, fault injection, device health and quarantine,
chunked and batched map-output serving, dense serving for device-shuffled
jobs, cooperative cancellation inside a running map
(a killed attempt is reported KILLED when it ends), the lost-master
backoff and the heartbeat delta encoding.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
import traceback

from tpumr_torch.device import DEVICE_KEY, select_device
from tpumr_torch.io import ifile
from tpumr_torch.ipc.rpc import RpcClient, RpcServer
from tpumr_torch.mapred.api import Reporter
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.jobtracker import PROTOCOL_VERSION
from tpumr_torch.mapred.map_task import run_map_task
from tpumr_torch.mapred.output_formats import FileOutputCommitter
from tpumr_torch.mapred.reduce_task import run_reduce_task
from tpumr_torch.mapred.shuffle_copier import (RemoteSegmentSource,
                                               TaskKilledError)
from tpumr_torch.mapred.task import Task, TaskPhase, TaskState, TaskStatus
from tpumr_torch.pipeline.handoff import (SERVE_PREFIX, HandoffSource,
                                          serve_key)

#: seconds ``stop`` waits for each of the runner's threads
JOIN_TIMEOUT_S = 10.0
#: heartbeats between two sweeps of the handoff entries
PURGE_EVERY_BEATS = 20

_log = logging.getLogger(__name__)


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
        if self.max_tpu_map_slots > 0:
            # no CUDA and no request for the CPU: raise, never run the
            # accelerator slots somewhere else
            dev = select_device(conf)
            if dev.type == "cpu":
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
        self.job_confs: "dict[str, JobConf]" = {}
        self.local_root = tempfile.mkdtemp(
            prefix=f"tpumr_torch-{self.name}-",
            dir=conf.get("mapred.local.dir") or None)
        self._response_id = 0
        self._initial_contact = True
        #: the last failed beat's error ("" after a beat that went through)
        self.heartbeat_error = ""
        self._stop = threading.Event()
        self._cpu_sem = threading.Semaphore(max(1, self.max_cpu_map_slots))
        self._tpu_sem = threading.Semaphore(max(1, self.max_tpu_map_slots))
        self._red_sem = threading.Semaphore(max(1, self.max_reduce_slots))
        self._task_threads: "set[threading.Thread]" = set()
        #: upstream job -> the stream source its downstream maps share
        self._handoff_sources: "dict[str, HandoffSource]" = {}
        self._beats = 0
        self._server = RpcServer(self, "127.0.0.1", 0)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"heartbeat-{self.name}",
            daemon=True)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "NodeRunner":
        self._server.start()
        self._hb_thread.start()
        return self

    def stop(self) -> None:
        """Stop heartbeating, join the task threads (each for at most
        ``JOIN_TIMEOUT_S``), close the shuffle server and the master
        connection, and delete the runner's local directory."""
        self._stop.set()
        if self._hb_thread.is_alive():
            self._hb_thread.join(JOIN_TIMEOUT_S)
        with self.lock:
            threads = list(self._task_threads)
        for t in threads:
            t.join(JOIN_TIMEOUT_S)
        self._server.stop()
        self.master.close()
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

    def _available_tpu_devices(self) -> "list[bool]":
        """free[i]: no running accelerator attempt holds device i."""
        free = [True] * self.n_tpu_devices
        for st in self.running.values():
            if (st.state == TaskState.RUNNING and st.run_on_tpu
                    and 0 <= st.tpu_device_id < self.n_tpu_devices):
                free[st.tpu_device_id] = False
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
            return {
                "tracker_name": self.name,
                "host": self.host,
                "shuffle_addr": f"127.0.0.1:{self.shuffle_port}",
                "shuffle_port": self.shuffle_port,
                "max_cpu_map_slots": self.max_cpu_map_slots,
                "max_tpu_map_slots": self.max_tpu_map_slots,
                "max_reduce_slots": self.max_reduce_slots,
                "count_cpu_map_tasks": cpu,
                "count_tpu_map_tasks": tpu,
                "count_reduce_tasks": red,
                "available_tpu_devices": self._available_tpu_devices(),
                "available_memory_mb": avail_mb,
                "task_statuses": [st.to_dict()
                                  for st in self.running.values()],
            }

    # ------------------------------------------------------------ heartbeat

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._heartbeat_once()
                self.heartbeat_error = ""
            except Exception as e:  # noqa: BLE001 — the next beat retries
                err = f"{type(e).__name__}: {e}"
                if err != self.heartbeat_error:
                    _log.warning("%s: heartbeat failed: %s", self.name, err)
                self.heartbeat_error = err
            self._stop.wait(self.heartbeat_s)

    def _heartbeat_once(self) -> None:
        full = self._status_dict()
        ask = (full["count_cpu_map_tasks"] < self.max_cpu_map_slots
               or full["count_tpu_map_tasks"] < self.max_tpu_map_slots
               or full["count_reduce_tasks"] < self.max_reduce_slots)
        resp = self.master.call("heartbeat", full, self._initial_contact,
                                ask, self._response_id)
        self._initial_contact = False
        self._response_id = resp["response_id"]
        with self.lock:
            # the master has these terminal statuses now; a task that
            # ended while the call was in flight was sent as RUNNING and
            # stays for the next beat
            for sd in full["task_statuses"]:
                if sd["state"] in TaskState.TERMINAL:
                    self.running.pop(sd["attempt_id"], None)
                    self.running_tasks.pop(sd["attempt_id"], None)
                    self._kill_requested.discard(sd["attempt_id"])
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
                self._handoff_sources.pop(job_id, None)
            shutil.rmtree(os.path.join(self.local_root, "handoff", job_id),
                          ignore_errors=True)

    def _apply_action(self, action: dict) -> None:
        kind = action.get("type")
        if kind == "launch":
            self._launch(action["job_id"], Task.from_dict(action["task"]))
        elif kind == "kill_task":
            with self.lock:
                if action["attempt_id"] in self.running:
                    self._kill_requested.add(action["attempt_id"])
        elif kind == "cleanup_job":
            job_id = action["job_id"]
            with self.lock:
                for key in [k for k in self.map_outputs if k[0] == job_id]:
                    del self.map_outputs[key]
                self.job_confs.pop(job_id, None)
            shutil.rmtree(os.path.join(self.local_root, job_id),
                          ignore_errors=True)

    # ------------------------------------------------------------ tasks

    def _job_conf(self, job_id: str) -> JobConf:
        with self.lock:
            jc = self.job_confs.get(job_id)
        if jc is None:
            jc = JobConf()
            for k, v in self.master.call("get_job_conf", job_id).items():
                jc.set(k, v)
            jc.set(DEVICE_KEY, self.device_key)   # the node's device
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
            self._task_threads.add(t)
        t.start()

    def _run_task(self, job_id: str, task: Task, status: TaskStatus) -> None:
        sem = (self._red_sem if not task.is_map
               else self._tpu_sem if task.run_on_tpu else self._cpu_sem)
        try:
            while not sem.acquire(timeout=0.1):
                if self._stop.is_set():
                    return
            try:
                self._run_task_inner(job_id, task, status)
            finally:
                sem.release()
        finally:
            with self.lock:
                self._task_threads.discard(threading.current_thread())

    def _killed(self, aid: str) -> bool:
        with self.lock:
            return aid in self._kill_requested or self._stop.is_set()

    def _run_task_inner(self, job_id: str, task: Task,
                        status: TaskStatus) -> None:
        aid = str(task.attempt_id)
        reporter = Reporter()
        try:
            conf = self._job_conf(job_id)
            local_dir = os.path.join(self.local_root, job_id, aid)
            handoff = None
            if task.is_map:
                path, index = run_map_task(conf, task, local_dir, reporter)
                if path:
                    with self.lock:
                        self.map_outputs[(job_id, task.partition)] = \
                            (path, index)
            else:
                source = RemoteSegmentSource(
                    job_id, task.num_maps,
                    lambda cursor: self.master.call(
                        "get_map_completion_events", job_id, cursor),
                    poll_s=conf.get_int("tpumr.shuffle.poll.ms",
                                        200) / 1000.0,
                    timeout_s=conf.get_int("tpumr.shuffle.timeout.ms",
                                           600_000) / 1000.0,
                    abort_check=lambda: self._killed(aid))
                handoff = run_reduce_task(conf, task, source, reporter)
                status.phase = TaskPhase.REDUCE
            committed = self._commit(conf, task)
            if handoff is not None:
                self._register_handoff(job_id, task, handoff, committed)
            with self.lock:
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
        except TaskKilledError as e:
            with self.lock:
                status.diagnostics = str(e)
                status.finish_time = time.time()
                status.state = TaskState.KILLED
        except Exception as e:  # noqa: BLE001 — a failed attempt is data
            with self.lock:
                status.diagnostics = (f"{type(e).__name__}: {e}\n"
                                      + traceback.format_exc(limit=8))
                status.finish_time = time.time()
                status.state = TaskState.FAILED

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
        with self.lock:
            self.map_outputs[(serve_key(job_id), task.partition)] = \
                (handoff["path"], handoff["index"])

    def _handoff_source(self, upstream_job: str) -> HandoffSource:
        """The stream source of one upstream job, shared by every map of
        the downstream stage on this runner: the master's handoff feed,
        folded by one cursor."""
        with self.lock:
            src = self._handoff_sources.get(upstream_job)
            if src is None:
                src = self._handoff_sources[upstream_job] = HandoffSource(
                    upstream_job,
                    lambda cursor: self.master.call(
                        "get_handoff_completion_events", upstream_job,
                        cursor),
                    poll_s=self.conf.get_int("tpumr.shuffle.poll.ms",
                                             200) / 1000.0)
            return src

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

    # ------------------------------------------------------------ shuffle

    def get_map_output(self, job_id: str, map_index: int,
                       partition: int) -> dict:
        """One partition's segment of a map's IFile, as it lies on disk."""
        with self.lock:
            ent = self.map_outputs.get((job_id, int(map_index)))
        if ent is None:
            raise KeyError(f"no map output for {job_id} map {map_index}")
        path, index = ent
        with open(path, "rb") as f:
            data = ifile.partition_bytes(f, index, int(partition))
        return {"data": data, "codec": index.get("codec", "none")}
