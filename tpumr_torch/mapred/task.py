"""The task record: one scheduled attempt and its accelerator placement,
its status on the wire, and its client-visible report.

Counterpart of ``Task``, ``TaskStatus``, ``TaskState``, ``TaskPhase`` and
``TaskReport`` in ``tpumr/mapred/task.py``. ``run_on_tpu`` and
``tpu_device_id`` keep the JAX package's names and mean "runs on the
accelerator" and "which card" (``dev_id % torch.cuda.device_count()``).
The master stamps them at assignment; the node runner reads them to pick
the map runner, and reports them back on every status, so the master can
sum each backend's runtimes (the hybrid scheduler's profile).

Left out: the failure classes (``FailureClass``, ``tag_failure``) that
drive the JAX package's TPU-to-CPU demotion, which the port does not have,
and the tracing context.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from tpumr_torch.mapred.ids import TaskAttemptID, TaskID


class TaskState:
    UNASSIGNED = "UNASSIGNED"
    RUNNING = "RUNNING"
    COMMIT_PENDING = "COMMIT_PENDING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"

    TERMINAL = {SUCCEEDED, FAILED, KILLED}


class TaskPhase:
    STARTING = "STARTING"
    MAP = "MAP"
    SHUFFLE = "SHUFFLE"
    SORT = "SORT"
    REDUCE = "REDUCE"
    CLEANUP = "CLEANUP"


@dataclass
class Task:
    attempt_id: TaskAttemptID
    partition: int                 # map: split index; reduce: partition index
    num_reduces: int = 1
    num_maps: int = 0              # reduce: the maps whose output it reads
    split: "dict | None" = None    # InputSplit.to_dict() for maps
    run_on_tpu: bool = False
    tpu_device_id: int = -1
    #: declared memory demand (mapred.job.{map,reduce}.memory.mb), stamped
    #: at assignment for the scheduler's memory matching
    memory_mb: int = 0
    #: a window's fetched kernel output for this map task
    #: (gpu_runner.prelaunch_device_maps); None outside the window path,
    #: and never on the wire
    device_prefetch: Any = None

    @property
    def is_map(self) -> bool:
        return self.attempt_id.task.is_map

    @property
    def task_id(self) -> TaskID:
        return self.attempt_id.task

    def to_dict(self) -> dict[str, Any]:
        return {"attempt_id": str(self.attempt_id),
                "partition": self.partition,
                "num_reduces": self.num_reduces, "split": self.split,
                "num_maps": self.num_maps, "run_on_tpu": self.run_on_tpu,
                "tpu_device_id": self.tpu_device_id,
                "memory_mb": self.memory_mb}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Task":
        return cls(attempt_id=TaskAttemptID.parse(d["attempt_id"]),
                   partition=d["partition"], num_reduces=d["num_reduces"],
                   split=d.get("split"), num_maps=d.get("num_maps", 0),
                   run_on_tpu=d.get("run_on_tpu", False),
                   tpu_device_id=d.get("tpu_device_id", -1),
                   memory_mb=d.get("memory_mb", 0))


@dataclass
class TaskStatus:
    """Per-attempt status, carried in heartbeats. ``start_time`` and
    ``finish_time`` are the node runner's stamps; their difference is the
    runtime the master sums per backend."""

    attempt_id: TaskAttemptID
    is_map: bool = True
    state: str = TaskState.RUNNING
    progress: float = 0.0
    phase: str = TaskPhase.STARTING
    start_time: float = field(default_factory=time.time)
    finish_time: float = 0.0
    diagnostics: str = ""
    counters: dict = field(default_factory=dict)
    run_on_tpu: bool = False
    tpu_device_id: int = -1

    @property
    def runtime(self) -> float:
        """Wall seconds, finish less start: the profiling signal of
        ``JobInProgress._on_success``."""
        end = self.finish_time or time.time()
        return max(0.0, end - self.start_time)

    def to_dict(self) -> dict[str, Any]:
        d = dict(self.__dict__)
        d["attempt_id"] = str(self.attempt_id)
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TaskStatus":
        d = dict(d)
        d["attempt_id"] = TaskAttemptID.parse(d["attempt_id"])
        return cls(**d)


@dataclass
class TaskReport:
    """Client-visible per-task report. The master stamps the placement at
    assignment."""

    task_id: TaskID
    state: str = TaskState.UNASSIGNED
    progress: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0
    successful_attempt: str = ""
    run_on_tpu: bool = False
    tpu_device_id: int = -1
