"""Total order: sampling the input, the partition file, and the range
partitioner.

Counterpart of ``tpumr/mapred/total_order.py``. ``sample_input`` draws keys
evenly across the first splits of the job's input; ``write_partition_file``
keeps ``R - 1`` cut points of the sorted samples (a repeated sample gives
one cut, so the list may be short) and writes them serialized, the same
bytes as the JAX package writes; :class:`TotalOrderPartitioner` sends a key
to ``bisect_left`` of the cuts, so a key equal to a cut stays in the lower
range, and part files in order are sorted as a whole.
"""

from __future__ import annotations

import bisect
from typing import Any

from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io.writable import deserialize, serialize
from tpumr_torch.mapred.api import Partitioner
from tpumr_torch.utils.reflection import new_instance

PARTITION_PATH_KEY = "total.order.partitioner.path"


def sample_input(conf: Any, num_samples: int = 1000,
                 max_splits: int = 10) -> list:
    """Up to ``num_samples`` keys: the first ``num_samples // splits`` of
    each of the first ``max_splits`` splits."""
    input_format = new_instance(conf.get_input_format(), conf)
    splits = input_format.get_splits(conf, conf.num_map_tasks_hint)
    splits = splits[:max_splits]
    if not splits:
        return []
    per_split = max(1, num_samples // len(splits))
    samples: list = []
    for split in splits:
        for i, (key, _value) in enumerate(
                input_format.get_record_reader(split, conf)):
            if i >= per_split:
                break
            samples.append(key)
    return samples


def write_partition_file(conf: Any, path: str, samples: list,
                         num_reduces: int) -> None:
    """Write the cut points to ``path`` and name it in ``conf``."""
    cuts: list = []
    if num_reduces > 1 and samples:
        ordered = sorted(samples)
        step = len(ordered) / num_reduces
        last = None
        for r in range(1, num_reduces):
            cand = ordered[min(len(ordered) - 1, int(round(r * step)))]
            if last is None or cand > last:
                cuts.append(cand)
                last = cand
    FileSystem.get(path, conf).write_bytes(path, serialize(cuts))
    conf.set(PARTITION_PATH_KEY, path)


class TotalOrderPartitioner(Partitioner):
    """The range of a key among the partition file's cut points."""

    def __init__(self) -> None:
        self._cuts: "list | None" = None

    def configure(self, conf: Any) -> None:
        path = conf.get(PARTITION_PATH_KEY)
        if not path:
            raise ValueError(f"{PARTITION_PATH_KEY} not set: call "
                             "write_partition_file before submitting")
        self._cuts = deserialize(FileSystem.get(path, conf).read_bytes(path))

    def get_partition(self, key: Any, value: Any, num_partitions: int) -> int:
        assert self._cuts is not None, "partitioner not configured"
        return min(bisect.bisect_left(self._cuts, key), num_partitions - 1)
