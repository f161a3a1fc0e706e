"""MiniMRCluster: a job master and N node runners in one process.

Counterpart of ``tpumr/mapred/mini_cluster.py``: real RPC over localhost
ports, real heartbeats, real shuffle fetches, and per-runner host names for
locality. Used as a context manager, it stops every runner's threads and
the master's, and closes every socket, on exit.

On a machine without CUDA, set ``tpumr_torch.device=cpu`` in ``conf``:
the accelerator slots then run the kernels' plain torch versions on the
CPU. Without it a cluster with accelerator slots asks for ``cuda`` and
raises there.
"""

from __future__ import annotations

from typing import Any

from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.jobtracker import JobMaster
from tpumr_torch.mapred.tasktracker import NodeRunner


class MiniMRCluster:
    def __init__(self, num_trackers: int = 2, conf: "JobConf | None" = None,
                 cpu_slots: int = 2, tpu_slots: int = 1,
                 tpu_devices_per_tracker: "int | None" = None,
                 hosts: "list[str] | None" = None) -> None:
        self.conf = JobConf(conf) if conf is not None else JobConf()
        if self.conf.get("tpumr.heartbeat.interval.ms") is None:
            self.conf.set("tpumr.heartbeat.interval.ms", 50)
        if self.conf.get("tpumr.tracker.expiry.ms") is None:
            self.conf.set("tpumr.tracker.expiry.ms", 5000)
        self.conf.set("mapred.tasktracker.map.cpu.tasks.maximum", cpu_slots)
        self.conf.set("mapred.tasktracker.map.tpu.tasks.maximum", tpu_slots)
        self.trackers: "list[NodeRunner]" = []
        self.master = JobMaster(self.conf).start()
        try:
            host, port = self.master.address
            for i in range(num_trackers):
                tracker = NodeRunner(
                    host, port, JobConf(self.conf), name=f"tracker_{i}",
                    host=(hosts[i] if hosts else "127.0.0.1"),
                    n_tpu_devices=tpu_devices_per_tracker)
                self.trackers.append(tracker.start())
        except BaseException:
            self.shutdown()
            raise

    @property
    def master_address(self) -> str:
        host, port = self.master.address
        return f"{host}:{port}"

    def create_job_conf(self) -> JobConf:
        conf = JobConf(self.conf)
        conf.set("mapred.job.tracker", self.master_address)
        return conf

    def shutdown(self) -> None:
        for t in self.trackers:
            t.stop()
        self.master.stop()

    def __enter__(self) -> "MiniMRCluster":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()
