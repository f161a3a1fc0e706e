"""Record batches: the unit a map task hands its mapper whole.

Counterpart of ``tpumr/io/recordbatch.py``: :class:`RecordBatch` (``:39-155``,
variable-length byte records as flat data plus offsets, trimmed to what the
text path uses) and :class:`DenseBatch` (``:175-205``). A ``RecordBatch``
stays on the host. A ``DenseBatch``'s ``values`` is a host numpy array as the
input format reads it, or a torch tensor once the runner has staged it onto
the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np


@dataclass
class RecordBatch:
    """Byte records as flat ``uint8`` data and ``int32`` offsets ``[n+1]``.
    The text path's batches have no keys (``key_data`` empty, every key
    offset 0)."""

    key_data: np.ndarray
    key_offsets: np.ndarray
    value_data: np.ndarray
    value_offsets: np.ndarray

    @classmethod
    def from_values(cls, values: Iterable[bytes]) -> "RecordBatch":
        """A key-less batch of ``values``, copied into one buffer."""
        vals = [bytes(v) for v in values]
        offsets = np.zeros(len(vals) + 1, dtype=np.int32)
        if vals:
            np.cumsum([len(v) for v in vals], out=offsets[1:])
        data = np.frombuffer(b"".join(vals), dtype=np.uint8).copy()
        return cls(np.zeros(0, np.uint8), np.zeros(len(vals) + 1, np.int32),
                   data, offsets)

    @classmethod
    def empty(cls) -> "RecordBatch":
        return cls(np.zeros(0, np.uint8), np.zeros(1, np.int32),
                   np.zeros(0, np.uint8), np.zeros(1, np.int32))

    @property
    def num_records(self) -> int:
        return len(self.key_offsets) - 1

    def value(self, i: int) -> bytes:
        return self.value_data[self.value_offsets[i]:
                               self.value_offsets[i + 1]].tobytes()

    @property
    def nbytes(self) -> int:
        return int(self.key_data.nbytes + self.value_data.nbytes
                   + self.key_offsets.nbytes + self.value_offsets.nbytes)

    def joined_values(self, sep: int = 0x20) -> bytes:
        """Every value in one buffer, ``sep`` between records: the whole
        split for a kernel that scans bytes."""
        if self.num_records == 0:
            return b""
        return np.insert(self.value_data,
                         self.value_offsets[1:-1].astype(np.int64),
                         sep).tobytes()


@dataclass
class DenseBatch:
    """Dense numeric records ``[n, d]`` (+ optional int64 record ids)."""

    values: Any                              # [n, d] np.ndarray or tensor
    ids: "np.ndarray | None" = None          # [n] int64 record ids
    meta: dict = field(default_factory=dict)

    @property
    def num_records(self) -> int:
        return int(self.values.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.values.nbytes
                   + (self.ids.nbytes if self.ids is not None else 0))
