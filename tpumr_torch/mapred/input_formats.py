"""Dense input: split planning over 2-D ``.npy`` files and split reads.

Counterpart of ``tpumr/mapred/input_formats.py:426-501`` (``load_dense``,
``read_npy_header``, ``DenseInputFormat``). It reads exactly the bytes the
JAX package reads, so both packages see the same splits of the same files.
"""

from __future__ import annotations

from io import BytesIO
from typing import Any

import numpy as np

from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io.recordbatch import DenseBatch
from tpumr_torch.mapred.split import DenseSplit, InputSplit


def load_dense(fs: FileSystem, path: str) -> np.ndarray:
    """Load a whole .npy array through the FS abstraction."""
    return np.load(BytesIO(fs.read_bytes(path)), allow_pickle=False)


def read_npy_header(f: Any) -> tuple[tuple[int, ...], np.dtype, int]:
    """Parse only the npy header: (shape, dtype, data_offset). C order is
    required (rows are addressed by byte range)."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    else:
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    if fortran:
        raise ValueError("Fortran-order .npy not supported for dense splits")
    return shape, dtype, f.tell()


class DenseInputFormat:
    """Each input path is a 2-D .npy array (or a directory of them); a split
    is a row range of ``tpumr.dense.split.rows`` rows, or an even share of
    ``num_splits``. Planning parses only the npy headers."""

    def get_splits(self, conf: Any, num_splits: int) -> list[InputSplit]:
        splits: list[InputSplit] = []
        for p in conf.get_strings("mapred.input.dir"):
            fs = FileSystem.get(p, conf)
            st = fs.get_status(p)
            stats = ([st] if not st.is_dir
                     else [s for s in fs.list_files(p, recursive=True)
                           if s.path.name.endswith(".npy")])
            for st in stats:
                with fs.open(st.path) as f:
                    shape, dtype, offset = read_npy_header(f)
                rows = shape[0]
                cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
                row_bytes = cols * dtype.itemsize
                per = conf.get_int("tpumr.dense.split.rows", 0) or \
                    max(1, -(-rows // max(1, num_splits)))
                for start in range(0, rows, per):
                    splits.append(DenseSplit(
                        ["localhost"], str(st.path), start,
                        min(per, rows - start), row_bytes, dtype.str, cols,
                        offset))
        return splits

    def read_batch(self, split: DenseSplit, conf: Any) -> DenseBatch:
        """The split's rows as a READ-ONLY numpy view over the bytes read:
        consumers compute from it or copy it to the device, never mutate
        it."""
        fs = FileSystem.get(split.path, conf)
        with fs.open(split.path) as f:
            f.seek(split.data_offset + split.row_start * split.row_bytes)
            raw = f.read(split.num_rows * split.row_bytes)
        arr = np.frombuffer(raw, dtype=np.dtype(split.dtype)).reshape(
            split.num_rows, split.cols)
        ids = np.arange(split.row_start, split.row_start + split.num_rows,
                        dtype=np.int64)
        return DenseBatch(arr, ids)
