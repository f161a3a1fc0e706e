"""Record batches: the unit a map task hands its mapper whole.

Counterpart of ``tpumr/io/recordbatch.py``: :class:`RecordBatch` (``:39-155``,
variable-length byte records as flat data plus offsets) and
:class:`DenseBatch` (``:175-205``). A ``RecordBatch`` stays on the host. A
``DenseBatch``'s ``values`` is a host numpy array as the input format reads
it, or a torch tensor once the runner has staged it onto the device.

Offsets are ``int32`` as in the JAX package while a column's bytes fit in
it, and ``int64`` beyond (:func:`offsets_dtype`): one 2.6 GB terasort part
file read whole holds 2.25 GB of values, past where ``int32`` offsets
would wrap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

import numpy as np


def offsets_dtype(total_bytes: int) -> type:
    """``int32`` while ``total_bytes`` fits in it, else ``int64``."""
    return np.int32 if total_bytes <= np.iinfo(np.int32).max else np.int64


def fixed_offsets(n: int, width: int) -> np.ndarray:
    """The offsets ``[n+1]`` of ``n`` records of ``width`` bytes each."""
    return (np.arange(n + 1, dtype=np.int64) * width).astype(
        offsets_dtype(n * width))


def _build_offsets(items: "list[bytes]") -> "tuple[np.ndarray, np.ndarray]":
    lengths = np.fromiter((len(b) for b in items), np.int64, len(items))
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    data = np.frombuffer(b"".join(items), dtype=np.uint8).copy()
    return data, offsets.astype(offsets_dtype(int(offsets[-1])))


@dataclass
class RecordBatch:
    """Byte records as flat ``uint8`` data and offsets ``[n+1]``. The text
    path's batches have no keys (``key_data`` empty, every key offset 0)."""

    key_data: np.ndarray
    key_offsets: np.ndarray
    value_data: np.ndarray
    value_offsets: np.ndarray

    @classmethod
    def from_pairs(cls, pairs: Iterable[tuple[bytes, bytes]]
                   ) -> "RecordBatch":
        keys, values = [], []
        for k, v in pairs:
            keys.append(bytes(k))
            values.append(bytes(v))
        return cls(*_build_offsets(keys), *_build_offsets(values))

    @classmethod
    def from_values(cls, values: Iterable[bytes]) -> "RecordBatch":
        """A key-less batch of ``values``, copied into one buffer."""
        vals = [bytes(v) for v in values]
        return cls(np.zeros(0, np.uint8), np.zeros(len(vals) + 1, np.int32),
                   *_build_offsets(vals))

    @classmethod
    def empty(cls) -> "RecordBatch":
        return cls(np.zeros(0, np.uint8), np.zeros(1, np.int32),
                   np.zeros(0, np.uint8), np.zeros(1, np.int32))

    @property
    def num_records(self) -> int:
        return len(self.key_offsets) - 1

    def key(self, i: int) -> bytes:
        return self.key_data[self.key_offsets[i]:
                             self.key_offsets[i + 1]].tobytes()

    def value(self, i: int) -> bytes:
        return self.value_data[self.value_offsets[i]:
                               self.value_offsets[i + 1]].tobytes()

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        for i in range(self.num_records):
            yield self.key(i), self.value(i)

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

    def padded_values(self, width: int, fill: int = 0
                      ) -> tuple[np.ndarray, np.ndarray]:
        """``([n, width] uint8, [n] int32 lengths)``; longer records are
        cut to ``width``. Fixed-width records come back as a reshape, no
        copy."""
        return _pad(self.value_data, self.value_offsets, width, fill)

    def padded_keys(self, width: int, fill: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
        return _pad(self.key_data, self.key_offsets, width, fill)

    @classmethod
    def concat(cls, batches: "list[RecordBatch]") -> "RecordBatch":
        if not batches:
            return cls.empty()

        def cat_offsets(offs: "list[np.ndarray]") -> np.ndarray:
            out = [offs[0].astype(np.int64)]
            base = int(offs[0][-1])
            for o in offs[1:]:
                out.append(o[1:].astype(np.int64) + base)
                base += int(o[-1])
            return np.concatenate(out).astype(offsets_dtype(base))

        return cls(np.concatenate([b.key_data for b in batches]),
                   cat_offsets([b.key_offsets for b in batches]),
                   np.concatenate([b.value_data for b in batches]),
                   cat_offsets([b.value_offsets for b in batches]))

    def slice(self, start: int, stop: int) -> "RecordBatch":
        ko = self.key_offsets[start: stop + 1]
        vo = self.value_offsets[start: stop + 1]
        return RecordBatch(
            self.key_data[ko[0]: ko[-1]].copy(),
            (ko - ko[0]).astype(offsets_dtype(int(ko[-1] - ko[0]))),
            self.value_data[vo[0]: vo[-1]].copy(),
            (vo - vo[0]).astype(offsets_dtype(int(vo[-1] - vo[0]))))


def _pad(data: np.ndarray, offsets: np.ndarray, width: int,
         fill: int) -> tuple[np.ndarray, np.ndarray]:
    n = len(offsets) - 1
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int32)
    if n and data.shape[0] == n * width and (lengths == width).all():
        return data.reshape(n, width), lengths
    out = np.full((n, width), fill, dtype=np.uint8)
    take = np.minimum(lengths, width)
    row_idx = np.repeat(np.arange(n), take)
    starts = np.repeat(np.cumsum(take, dtype=np.int64) - take, take)
    col_idx = np.arange(int(take.sum()), dtype=np.int64) - starts
    src_idx = np.repeat(offsets[:-1].astype(np.int64), take) + col_idx
    out[row_idx, col_idx] = data[src_idx]
    return out, lengths


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
