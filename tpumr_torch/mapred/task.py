"""The task record: one scheduled attempt and its accelerator placement.

Counterpart of ``Task`` in ``tpumr/mapred/task.py``. ``run_on_tpu`` and
``tpu_device_id`` keep the JAX package's names and mean "runs on the
accelerator" and "which card" (``dev_id % torch.cuda.device_count()``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from tpumr_torch.mapred.ids import TaskAttemptID


@dataclass
class Task:
    attempt_id: TaskAttemptID
    partition: int                 # map: split index; reduce: partition index
    num_reduces: int = 1
    num_maps: int = 0              # reduce: the maps whose output it reads
    split: "dict | None" = None    # InputSplit.to_dict() for maps
    run_on_tpu: bool = False
    tpu_device_id: int = -1
    #: a window's fetched kernel output for this map task
    #: (gpu_runner.prelaunch_device_maps); None outside the window path
    device_prefetch: Any = None

    @property
    def is_map(self) -> bool:
        return self.attempt_id.task.is_map
