"""JobClient: job submission and monitoring.

Counterpart of ``tpumr/mapred/job_client.py`` (``:74-183``). With
``mapred.job.tracker`` unset or ``local`` a job runs in this process
through the port's ``LocalJobRunner``; with ``host:port`` the client
computes the splits itself (:func:`build_submission`), sends the conf and
the splits' dicts to that job master over RPC, and polls it
(:class:`RunningJob`). Classes travel as dotted names of importable
modules (:func:`_wire_conf` raises on a class object).

A device-shuffled job (``JobConf.set_device_shuffle``) is planned at
submission (``device_shuffle.prepare_device_shuffle_job``, ``:142-143``):
one gang reduce task, the reduces asked for kept as its output ranges; a
custom key comparator, a grouping comparator or missing widths are refused
there.

A master restart (``:23-40, 88-95``): the client's calls retry a failed
connection ``tpumr.jobclient.rpc.retries`` times (default 3) with a
doubling backoff, and every status poll rebinds :class:`RunningJob` to the
id the status names, so that a client polling a job that a restarted
master recovered under a new id follows it. Left out: credentials and
tokens, and the submitting user's name.
"""

from __future__ import annotations

import time
from typing import Any

from tpumr_torch.core.counters import Counters
from tpumr_torch.ipc.rpc import RpcClient
from tpumr_torch.mapred.device_shuffle import prepare_device_shuffle_job
from tpumr_torch.mapred.ids import JobID
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import JobResult, LocalJobRunner
from tpumr_torch.utils.reflection import new_instance

TERMINAL = ("SUCCEEDED", "FAILED", "KILLED")


class RunningJob:
    """A job submitted to a master: its status, counters and reports.
    ``job_id`` follows the job across a master restart."""

    def __init__(self, client: RpcClient, job_id: str) -> None:
        self._client = client
        self.job_id = job_id

    def status(self) -> dict:
        st = self._client.call("get_job_status", self.job_id)
        new_id = st.get("job_id")
        if new_id and new_id != self.job_id:
            self.job_id = new_id   # recovered under a new id
        return st

    def is_complete(self) -> bool:
        return self.status()["state"] in TERMINAL

    def is_successful(self) -> bool:
        return self.status()["state"] == "SUCCEEDED"

    def counters(self) -> Counters:
        return Counters.from_dict(self._client.call("get_counters",
                                                    self.job_id))

    def task_reports(self, kind: str = "map") -> "list[dict]":
        return self._client.call("get_task_reports", self.job_id, kind)

    def kill(self) -> bool:
        return bool(self._client.call("kill_job", self.job_id))

    def wait_for_completion(self, timeout: float = 3600.0,
                            poll_s: float = 0.05) -> dict:
        """The terminal status; ``TimeoutError`` after ``timeout``
        seconds."""
        deadline = time.monotonic() + timeout
        while True:
            st = self.status()
            if st["state"] in TERMINAL:
                return st
            if time.monotonic() > deadline:
                raise TimeoutError(f"job {self.job_id} did not finish "
                                   f"within {timeout}s: {st}")
            time.sleep(poll_s)


class JobClient:
    def __init__(self, conf: JobConf) -> None:
        self.conf = conf
        tracker = conf.get("mapred.job.tracker")
        self._client: "RpcClient | None" = None
        if tracker and tracker != "local":
            host, port = str(tracker).rsplit(":", 1)
            self._client = RpcClient(host, int(port), retries=conf.get_int(
                "tpumr.jobclient.rpc.retries", 3))

    @property
    def is_local(self) -> bool:
        return self._client is None

    def close(self) -> None:
        if self._client is not None:
            self._client.close()

    def submit_job(self, job_conf: JobConf) -> RunningJob:
        assert self._client is not None, "local jobs use run_job()"
        conf_dict, splits = build_submission(job_conf)
        job_id = self._client.call("submit_job", conf_dict, splits)
        return RunningJob(self._client, job_id)

    def run_job(self, job_conf: JobConf,
                timeout: float = 3600.0) -> JobResult:
        """Submit and wait. A cluster job that fails raises
        ``RuntimeError`` with the master's error."""
        if self.is_local:
            return LocalJobRunner().submit_job(job_conf)
        running = self.submit_job(job_conf)
        t0 = time.monotonic()
        st = running.wait_for_completion(timeout)
        result = JobResult(job_id=JobID.parse(running.job_id),
                           successful=st["state"] == "SUCCEEDED",
                           counters=running.counters(),
                           num_maps=st["num_maps"],
                           num_reduces=st["num_reduces"],
                           wall_time=time.monotonic() - t0)
        if not result.successful:
            raise RuntimeError(f"job {running.job_id} {st['state']}: "
                               f"{st.get('error', '')}")
        return result


def build_submission(job_conf: JobConf) -> "tuple[dict, list[dict]]":
    """The client side of a submission: plan a device-shuffled job's
    reduce phase, check the output spec, compute the splits, and serialise
    the conf. Returns ``(conf_dict, split_dicts)`` for the master's
    ``submit_job``."""
    prepare_device_shuffle_job(job_conf)   # the reduces -> one gang task
    conf_dict = _wire_conf(job_conf)
    in_fmt = new_instance(job_conf.get_input_format(), job_conf)
    new_instance(job_conf.get_output_format(), job_conf) \
        .check_output_specs(job_conf)
    splits = in_fmt.get_splits(job_conf, job_conf.num_map_tasks_hint)
    return conf_dict, [s.to_dict() for s in splits]


def _wire_conf(job_conf: JobConf) -> "dict[str, Any]":
    """The conf as a plain dict for the wire; a class object (a class the
    master's side cannot import by name) raises."""
    out: "dict[str, Any]" = {}
    for k, v in job_conf:
        if isinstance(v, type):
            raise ValueError(
                f"conf key {k!r} holds a class object that is not importable "
                f"by name; distributed jobs need module-level classes")
        out[k] = v
    return out


def run_job(conf: JobConf) -> JobResult:
    """Submit ``conf`` and wait, locally or on the master it names."""
    client = JobClient(conf)
    try:
        return client.run_job(conf)
    finally:
        client.close()
