"""Input splits: what a map task reads, shipped to the task as a dict.

Counterpart of ``tpumr/mapred/split.py`` (``InputSplit``, ``FileSplit``,
``DenseSplit``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from tpumr_torch.utils.reflection import resolve_class


@dataclass
class InputSplit:
    locations: list[str] = field(default_factory=list)

    @property
    def length(self) -> int:
        return 0

    def to_dict(self) -> dict[str, Any]:
        return {"type": f"{type(self).__module__}.{type(self).__qualname__}",
                **self.__dict__}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "InputSplit":
        d = dict(d)
        return resolve_class(d.pop("type"))(**d)


@dataclass
class FileSplit(InputSplit):
    """Bytes [start, start + split_length) of a file. A line reader owns
    the lines that start in it (``input_formats.LineRecordReader``)."""
    path: str = ""
    start: int = 0
    split_length: int = 0

    @property
    def length(self) -> int:
        return self.split_length


@dataclass
class DenseSplit(InputSplit):
    """Rows [row_start, row_start + num_rows) of a 2-D ``.npy`` file: the
    unit the device runner stages in one transfer. dtype, cols and
    data_offset come from the npy header at split time, so a reader seeks
    straight to the byte range."""
    path: str = ""
    row_start: int = 0
    num_rows: int = 0
    row_bytes: int = 0
    dtype: str = "<f4"
    cols: int = 1
    data_offset: int = 0

    @property
    def length(self) -> int:
        return self.num_rows * self.row_bytes
