"""Job counters: named groups of named integer counters.

Counterpart of ``tpumr/core/counters.py``. The group and counter name
strings are the JAX package's, so the counters of a job run through either
package compare key by key. "TPU" in a name means "accelerator slot".
"""

from __future__ import annotations

import threading


class TaskCounter:
    MAP_INPUT_RECORDS = "MAP_INPUT_RECORDS"
    MAP_OUTPUT_RECORDS = "MAP_OUTPUT_RECORDS"
    MAP_OUTPUT_BYTES = "MAP_OUTPUT_BYTES"
    COMBINE_INPUT_RECORDS = "COMBINE_INPUT_RECORDS"
    COMBINE_OUTPUT_RECORDS = "COMBINE_OUTPUT_RECORDS"
    REDUCE_INPUT_GROUPS = "REDUCE_INPUT_GROUPS"
    REDUCE_INPUT_RECORDS = "REDUCE_INPUT_RECORDS"
    REDUCE_OUTPUT_RECORDS = "REDUCE_OUTPUT_RECORDS"
    #: the shuffle's copy phase (mapred/shuffle_copier.py): raw and wire
    #: bytes copied, segments landed in memory and on disk, fetch failures
    #: survived, and the background merges with the segments they took
    REDUCE_SHUFFLE_BYTES = "REDUCE_SHUFFLE_BYTES"
    REDUCE_SHUFFLE_WIRE_BYTES = "REDUCE_SHUFFLE_WIRE_BYTES"
    REDUCE_SHUFFLE_SEGMENTS_MEM = "REDUCE_SHUFFLE_SEGMENTS_MEM"
    REDUCE_SHUFFLE_SEGMENTS_DISK = "REDUCE_SHUFFLE_SEGMENTS_DISK"
    REDUCE_FETCH_FAILURES = "REDUCE_FETCH_FAILURES"
    SHUFFLE_INMEM_MERGES = "SHUFFLE_INMEM_MERGES"
    SHUFFLE_INMEM_MERGE_SEGMENTS = "SHUFFLE_INMEM_MERGE_SEGMENTS"
    SHUFFLE_DISK_MERGES = "SHUFFLE_DISK_MERGES"
    SHUFFLE_DISK_MERGE_SEGMENTS = "SHUFFLE_DISK_MERGE_SEGMENTS"
    SPILLED_RECORDS = "SPILLED_RECORDS"
    #: intermediate merge passes (io/merger.py), and the runs they merged
    MERGE_PASSES = "MERGE_PASSES"
    MERGE_PASS_SEGMENTS = "MERGE_PASS_SEGMENTS"
    FRAMEWORK_GROUP = "tpumr.TaskCounter"


class BackendCounter:
    CPU_MAP_TASKS = "CPU_MAP_TASKS"
    TPU_MAP_TASKS = "TPU_MAP_TASKS"
    CPU_MAP_MILLIS = "CPU_MAP_MILLIS"
    TPU_MAP_MILLIS = "TPU_MAP_MILLIS"
    TPU_DEVICE_BYTES_STAGED = "TPU_DEVICE_BYTES_STAGED"
    CPU_BATCH_MAP_TASKS = "CPU_BATCH_MAP_TASKS"
    TPU_SHUFFLE_RECORDS = "TPU_SHUFFLE_RECORDS"
    TPU_SHUFFLE_BYTES = "TPU_SHUFFLE_BYTES"
    #: device-shuffled reduces whose sort ran on the card (not the CPU)
    DEVICE_SORT_ON_ACCEL = "DEVICE_SORT_ON_ACCEL"
    SHUFFLE_HOST_FALLBACKS = "SHUFFLE_HOST_FALLBACKS"
    GROUP = "tpumr.BackendCounter"


class JobCounter:
    LAUNCHED_MAP_TASKS = "LAUNCHED_MAP_TASKS"
    LAUNCHED_REDUCE_TASKS = "LAUNCHED_REDUCE_TASKS"
    #: maps pinned to the CPU slots after device or compile failures on an
    #: accelerator slot, and attempts the node runner's reaper failed for
    #: silence (failure class ``timeout``)
    TPU_DEMOTIONS = "TPU_DEMOTIONS"
    TASKS_REAPED_TIMEOUT = "TASKS_REAPED_TIMEOUT"
    GROUP = "tpumr.JobCounter"


class Counters:
    """Thread-safe counter set: (group, name) -> int."""

    def __init__(self) -> None:
        self._values: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()

    def incr(self, group: str, name: str, amount: int = 1) -> None:
        with self._lock:
            key = (group, name)
            self._values[key] = self._values.get(key, 0) + int(amount)

    def value(self, group: str, name: str) -> int:
        with self._lock:
            return self._values.get((group, name), 0)

    def to_dict(self) -> dict[str, dict[str, int]]:
        """{group: {name: value}}, as ``tpumr.core.counters.Counters``."""
        out: dict[str, dict[str, int]] = {}
        with self._lock:
            for (group, name), v in sorted(self._values.items()):
                out.setdefault(group, {})[name] = v
        return out

    @classmethod
    def from_dict(cls, d: "dict[str, dict[str, int]]") -> "Counters":
        """The inverse of :meth:`to_dict`, for counters off the wire."""
        out = cls()
        for group, names in (d or {}).items():
            for name, v in names.items():
                out.incr(group, name, v)
        return out

    def merge(self, other: "Counters") -> None:
        """Add every counter of ``other`` into this set."""
        with other._lock:
            values = dict(other._values)
        for (group, name), v in values.items():
            self.incr(group, name, v)
