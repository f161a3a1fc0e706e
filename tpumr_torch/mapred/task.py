"""The task record: one scheduled attempt and its accelerator placement,
its status on the wire, and its client-visible report.

Counterpart of ``Task``, ``TaskStatus``, ``TaskState``, ``TaskPhase`` and
``TaskReport`` in ``tpumr/mapred/task.py``. ``run_on_tpu`` and
``tpu_device_id`` keep the JAX package's names and mean "runs on the
accelerator" and "which card" (``dev_id % torch.cuda.device_count()``).
The master stamps them at assignment; the node runner reads them to pick
the map runner, and reports them back on every status, so the master can
sum each backend's runtimes (the hybrid scheduler's profile).

The failure classes are the JAX package's (``:47-125`` there):
:class:`FailureClass`, :func:`tag_failure` (a class stamped at the failure
site), :func:`classify_exception` (the settle's generic rule) and
:func:`classify_accelerator_exception` (the accelerator runner's). A
failed attempt's class travels on ``TaskStatus.failure_class`` to the
master, where ``device`` and ``compile`` demote a map to the CPU slots and,
counted over distinct maps, quarantine the job's accelerator pass; the
node runner also counts ``device`` failures against the card for its
device quarantine. The accelerator rule is the port's own, since the JAX
one knows JAX and XLA text only:

- out of memory first: ``torch.OutOfMemoryError`` and "CUDA out of
  memory" are ``oom``, which does not demote;
- ``device``: ``torch.AcceleratorError`` where the installed torch has it,
  an exception class of ``torch.cuda``, and any error whose text carries
  ``CUDA error``, ``cudaError`` (the port's own launch failures,
  "kmeans_assign launch failed: cudaError N"), ``CUBLAS_STATUS_`` or
  ``CUDNN_STATUS_``;
- ``compile``: only a site's tag or ``ops/native.KernelBuildError`` (no
  ``nvcc``, a failed build, a library that does not load), never guessed
  from text. The kernels are built before their first launch, so no
  compile error hides inside a launch's;
- ``user``: the rest, such as the ``RuntimeError`` of a shape mismatch in a
  mapper's ``torch.mm``. The word "torch" in a message indicts nothing.

Left out: the tracing context.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any

from tpumr_torch.mapred.ids import TaskAttemptID, TaskID

#: the CUDA runtime's and libraries' wording of a device error, lower case
_CUDA_WORDING = ("cuda error", "cudaerror", "cublas_status_",
                 "cudnn_status_")


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


class FailureClass:
    """Why an attempt failed: whether the accelerator is to blame (demote
    the map, quarantine the card) or the user's code (attempts burn as
    usual). Set at the failure site or by the settle's rule, carried on
    :class:`TaskStatus`."""

    DEVICE = "device"      # the CUDA runtime or the card misbehaved
    COMPILE = "compile"    # a kernel did not build or load
    OOM = "oom"            # host or card memory exhausted
    USER = "user"          # user code raised: the backend is innocent
    TIMEOUT = "timeout"    # reaped: stopped reporting progress

    #: the classes that indict the accelerator path; OOM is not one (a
    #: split too big for the card usually exhausts the host path too)
    ACCELERATOR = {DEVICE, COMPILE}


def tag_failure(exc: BaseException, failure_class: str) -> BaseException:
    """Stamp ``failure_class`` on ``exc`` at its site; the first stamp
    wins. An exception that takes no attribute stays unclassified."""
    if not getattr(exc, "failure_class", ""):
        try:
            exc.failure_class = failure_class  # type: ignore[attr-defined]
        except (AttributeError, TypeError):
            pass
    return exc


def _is_oom(exc: BaseException) -> bool:
    if isinstance(exc, MemoryError):
        return True
    torch = sys.modules.get("torch")
    oom_type = getattr(torch, "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = f"{type(exc).__name__}: {exc}".lower()
    return ("resource_exhausted" in text or "out of memory" in text
            or "hbm" in text and "exhaust" in text)


def _is_build_failure(exc: BaseException) -> bool:
    # no import: a kernel build that was never tried raised nothing
    native = sys.modules.get("tpumr_torch.ops.native")
    return native is not None and isinstance(exc, native.KernelBuildError)


def classify_exception(exc: BaseException) -> str:
    """The settle's rule, with no site: a site's tag wins; a kernel build
    or load failure is ``compile``; memory exhaustion, by type or wording,
    is ``oom``; anything else is the user code's fault."""
    fc = getattr(exc, "failure_class", "")
    if fc:
        return str(fc)
    if _is_build_failure(exc):
        return FailureClass.COMPILE
    return FailureClass.OOM if _is_oom(exc) else FailureClass.USER


def classify_accelerator_exception(exc: BaseException) -> str:
    """The accelerator runner's rule, at its stage and execute sites and at
    the fetch that synchronises with the card (module docstring)."""
    fc = getattr(exc, "failure_class", "")
    if fc:
        return str(fc)
    if _is_build_failure(exc):
        return FailureClass.COMPILE
    if _is_oom(exc):
        return FailureClass.OOM
    torch = sys.modules.get("torch")
    accel_type = getattr(torch, "AcceleratorError", None)
    if accel_type is not None and isinstance(exc, accel_type):
        return FailureClass.DEVICE
    # the top-level package and its CUDA module, not a prefix of the name:
    # torchvision's or a user package's errors do not indict the card
    mod = (type(exc).__module__ or "").split(".")
    if mod[:2] == ["torch", "cuda"]:
        return FailureClass.DEVICE
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(w in text for w in _CUDA_WORDING):
        return FailureClass.DEVICE
    return FailureClass.USER


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
    #: the attempt's Reporter while it runs (``map_task.run_map_task``), for
    #: a kernel mapper that polls the kill flag; never on the wire
    reporter: Any = None

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
    #: why a FAILED attempt failed (:class:`FailureClass`); "" otherwise
    failure_class: str = ""

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
