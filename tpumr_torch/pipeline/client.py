"""Pipeline submission and monitoring: the JobClient of DAGs.

Counterpart of ``tpumr/pipeline/client.py``. One RPC submits the whole
validated graph; the master submits every stage from then on (split
computation included), so an N-stage chain costs one client round trip
instead of N submissions each polled to its end.

Left out: credentials and the submitting user's name (the port has no
security layer), following a master restart, and ``trace`` (the port has
no tracing).
"""

from __future__ import annotations

import time

from tpumr_torch.ipc.rpc import RpcClient
from tpumr_torch.pipeline.graph import JobGraph

TERMINAL = ("SUCCEEDED", "FAILED", "KILLED")


class RunningPipeline:
    def __init__(self, client: RpcClient, pipeline_id: str) -> None:
        self._client = client
        self.pipeline_id = pipeline_id

    def status(self) -> dict:
        return self._client.call("get_pipeline_status", self.pipeline_id)

    def is_complete(self) -> bool:
        return self.status()["state"] in TERMINAL

    def kill(self) -> bool:
        return bool(self._client.call("kill_pipeline", self.pipeline_id))

    def wait_for_completion(self, poll_s: float = 0.2,
                            timeout: float = 3600.0) -> dict:
        """The terminal status; ``TimeoutError`` after ``timeout``
        seconds."""
        deadline = time.monotonic() + timeout
        while True:
            st = self.status()
            if st["state"] in TERMINAL:
                return st
            if time.monotonic() > deadline:
                raise TimeoutError(f"pipeline {self.pipeline_id} did not "
                                   f"finish within {timeout}s: {st}")
            time.sleep(poll_s)


class PipelineClient:
    def __init__(self, conf) -> None:
        self.conf = conf
        tracker = conf.get("mapred.job.tracker")
        if not tracker or tracker == "local":
            raise ValueError(
                "pipelines need a cluster master (mapred.job.tracker); run "
                "the stages one by one through LocalJobRunner without one")
        host, port = str(tracker).rsplit(":", 1)
        self._client = RpcClient(host, int(port), retries=conf.get_int(
            "tpumr.jobclient.rpc.retries", 3))

    def close(self) -> None:
        self._client.close()

    def submit(self, graph: "JobGraph | dict") -> RunningPipeline:
        """Validate here (a bad graph fails before anything is sent), then
        send the wire form; the master validates it again."""
        if isinstance(graph, JobGraph):
            graph = graph.validate().to_dict()
        else:
            JobGraph.from_dict(graph).validate()
        pid = self._client.call("submit_pipeline", dict(graph))
        return RunningPipeline(self._client, pid)

    def list(self) -> "list[dict]":
        return self._client.call("list_pipelines")

    def status(self, pipeline_id: str) -> dict:
        return self._client.call("get_pipeline_status", pipeline_id)

    def running(self, pipeline_id: str) -> RunningPipeline:
        return RunningPipeline(self._client, pipeline_id)


def run_pipeline(conf, graph: "JobGraph | dict",
                 timeout: float = 3600.0) -> dict:
    """Submit and wait; ``RuntimeError`` unless the pipeline succeeded."""
    client = PipelineClient(conf)
    try:
        running = client.submit(graph)
        st = running.wait_for_completion(timeout=timeout)
    finally:
        client.close()
    if st["state"] != "SUCCEEDED":
        raise RuntimeError(f"pipeline {running.pipeline_id} {st['state']}: "
                           f"{st.get('error', '')}")
    return st
