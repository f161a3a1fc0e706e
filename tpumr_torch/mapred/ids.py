"""Job, task and attempt identifiers.

Counterpart of ``tpumr/mapred/ids.py``, with the same string shapes:
``job_<cluster>_<n>``, ``task_<cluster>_<n>_[mr]_<t>``,
``attempt_<cluster>_<n>_[mr]_<t>_<a>``. The job master mints them and
``parse`` reads them back off the wire.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class JobID:
    cluster: str
    id: int

    def __str__(self) -> str:
        return f"job_{self.cluster}_{self.id:04d}"

    @classmethod
    def parse(cls, s: str) -> "JobID":
        _, cluster, n = s.rsplit("_", 2)
        return cls(cluster, int(n))


@dataclass(frozen=True, order=True)
class TaskID:
    job: JobID
    is_map: bool
    id: int

    def __str__(self) -> str:
        kind = "m" if self.is_map else "r"
        return f"task_{self.job.cluster}_{self.job.id:04d}_{kind}_{self.id:06d}"

    @classmethod
    def parse(cls, s: str) -> "TaskID":
        parts = s.split("_")
        return cls(JobID(parts[1], int(parts[2])), parts[3] == "m",
                   int(parts[4]))


@dataclass(frozen=True, order=True)
class TaskAttemptID:
    task: TaskID
    attempt: int

    def __str__(self) -> str:
        t = self.task
        kind = "m" if t.is_map else "r"
        return (f"attempt_{t.job.cluster}_{t.job.id:04d}_{kind}_"
                f"{t.id:06d}_{self.attempt}")

    @classmethod
    def parse(cls, s: str) -> "TaskAttemptID":
        task, attempt = s.rsplit("_", 1)
        return cls(TaskID.parse(task), int(attempt))
