"""Input formats: split planning and record readers, text and dense.

Counterpart of ``tpumr/mapred/input_formats.py``: ``FileInputFormat``,
``LineRecordReader``, ``TextInputFormat``, ``RawTextInputFormat``,
``BytesTextInputFormat``, ``KeyValueTextInputFormat`` and
``NLineInputFormat`` (``:42-318``), ``SequenceFileInputFormat``
(``:319-350``), ``WholeFileInputFormat``, ``CombineFileInputFormat`` and
``MultiFileSplit`` (``:350-420``), and ``load_dense``, ``read_npy_header``
and ``DenseInputFormat`` (``:426-501``). Splits and records are the JAX
package's, byte for byte: a text split is planned as
``max(min, min(goal, block, max))`` bytes with the 1.1 split slop, and owns
every line that starts at a position up to its end.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from io import BytesIO
from typing import Any, Iterator

import numpy as np

from tpumr_torch.fs.filesystem import FileStatus, FileSystem
from tpumr_torch.io import sequencefile
from tpumr_torch.io.recordbatch import DenseBatch, RecordBatch
from tpumr_torch.mapred.split import DenseSplit, FileSplit, InputSplit


def _hidden(name: str) -> bool:
    return name.startswith("_") or name.startswith(".")


def _hosts(fs: FileSystem, st: FileStatus, offset: int, length: int
           ) -> list[str]:
    hosts: list[str] = []
    for loc in fs.get_block_locations(st.path, offset, length):
        hosts += [h for h in loc.hosts if h not in hosts]
    return hosts


class FileInputFormat:
    """Lists the input files (hidden names skipped) and cuts each into
    splits of ``max(mapred.min.split.size, min(goal, block size,
    mapred.max.split.size))`` bytes, ``goal`` being the total over the map
    count hint; a tail under 1.1 splits rides with the last split. A format
    that is not ``splittable`` makes one split of each whole file."""

    splittable = True

    def list_input_files(self, conf: Any
                         ) -> list[tuple[FileSystem, FileStatus]]:
        out: list[tuple[FileSystem, FileStatus]] = []
        for p in conf.get_strings("mapred.input.dir"):
            fs = FileSystem.get(p, conf)
            if any(c in p for c in "*?["):
                stats = fs.glob_status(p)
            elif fs.exists(p):
                st = fs.get_status(p)
                stats = fs.list_status(p) if st.is_dir else [st]
            else:
                raise FileNotFoundError(f"input path does not exist: {p}")
            for st in stats:
                if st.is_dir:
                    out += [(fs, sub)
                            for sub in fs.list_files(st.path, recursive=True)
                            if not _hidden(sub.path.name)]
                elif not _hidden(st.path.name):
                    out.append((fs, st))
        return out

    def get_splits(self, conf: Any, num_splits: int) -> list[InputSplit]:
        files = self.list_input_files(conf)
        total = sum(st.length for _, st in files)
        goal = max(1, total // max(1, num_splits))
        min_size = conf.get_int("mapred.min.split.size", 1)
        max_size = conf.get_int("mapred.max.split.size", 2**63 - 1)
        splits: list[InputSplit] = []
        for fs, st in files:
            if st.length == 0:
                continue
            if not self.splittable:
                splits.append(FileSplit(_hosts(fs, st, 0, st.length),
                                        str(st.path), 0, st.length))
                continue
            size = max(min_size, min(goal, st.block_size, max_size))
            pos, remaining = 0, st.length
            while remaining / size > 1.1:
                splits.append(FileSplit(_hosts(fs, st, pos, size),
                                        str(st.path), pos, size))
                pos += size
                remaining -= size
            if remaining:
                splits.append(FileSplit(_hosts(fs, st, pos, remaining),
                                        str(st.path), pos, remaining))
        return splits


class LineRecordReader:
    """(byte offset, line) records of a split: it skips the partial line
    it starts in (unless it starts at 0) and owns each line that starts at
    a position up to its end, reading past the end to finish the last.
    A line loses its trailing ``\\r``/``\\n`` bytes; values are bytes with
    ``keep_bytes``, else ``decode("utf-8", "replace")`` of them."""

    def __init__(self, fs: FileSystem, path: str, start: int, length: int,
                 keep_bytes: bool = False) -> None:
        self._f = fs.open(path)
        self._end = start + length
        self._keep_bytes = keep_bytes
        self._pos = start
        self._f.seek(start)
        if start > 0:
            self._pos += len(self._f.readline())

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        try:
            while self._pos <= self._end:
                line = self._f.readline()
                if not line:
                    break
                offset = self._pos
                self._pos += len(line)
                stripped = line.rstrip(b"\r\n")
                yield offset, (stripped if self._keep_bytes
                               else stripped.decode("utf-8", "replace"))
        finally:
            self._f.close()


class TextInputFormat(FileInputFormat):
    """(byte offset, line) records, lines decoded as UTF-8 with
    replacement."""

    keep_bytes = False

    def get_record_reader(self, split: FileSplit, conf: Any,
                          reporter: Any = None) -> Iterator[tuple[int, Any]]:
        fs = FileSystem.get(split.path, conf)
        return iter(LineRecordReader(fs, split.path, split.start,
                                     split.split_length, self.keep_bytes))

    @staticmethod
    def _read_owned_bytes(split: FileSplit, conf: Any) -> bytes:
        """The bytes of the lines the split owns, by
        :class:`LineRecordReader`'s rule: past the first newline unless
        the split starts at 0 (a split with no newline owns nothing), then
        on to the end of the line that holds its last byte."""
        fs = FileSystem.get(split.path, conf)
        with fs.open(split.path) as f:
            f.seek(split.start)
            buf = f.read(split.split_length)
            if split.start > 0:
                nl = buf.find(b"\n")
                if nl < 0:
                    return b""
                buf = buf[nl + 1:]
            buf += f.readline()
        return buf

    def read_batch(self, split: FileSplit, conf: Any) -> RecordBatch:
        """The split's lines in one batch, from one read and a numpy
        newline scan: the records of :meth:`get_record_reader` as UTF-8
        bytes. Invalid UTF-8 takes the reader's ``decode("utf-8",
        "replace")`` line by line."""
        buf = self._read_owned_bytes(split, conf)
        if not buf:
            return RecordBatch.empty()
        arr = np.frombuffer(buf, dtype=np.uint8)
        nls = np.flatnonzero(arr == 0x0A).astype(np.int64)
        starts = np.concatenate(([0], nls + 1))
        ends = np.concatenate((nls, [arr.shape[0]]))
        if starts[-1] >= arr.shape[0] and len(starts) > 1:
            starts, ends = starts[:-1], ends[:-1]   # buf ended with \n
        keep = arr != 0x0A
        while True:     # rstrip(b"\r\n"): drop every trailing \r too
            has_cr = (ends > starts) & (arr[np.maximum(ends - 1, 0)] == 0x0D)
            if not has_cr.any():
                break
            ends = ends - has_cr
            keep[ends[has_cr]] = False
        offsets = np.zeros(len(starts) + 1, np.int32)
        np.cumsum(ends - starts, out=offsets[1:])
        batch = RecordBatch(np.zeros(0, np.uint8),
                            np.zeros(len(starts) + 1, np.int32), arr[keep],
                            offsets)
        if not self.keep_bytes and (batch.value_data > 0x7F).any():
            try:
                batch.joined_values(0x0A).decode("utf-8")
            except UnicodeDecodeError:
                return RecordBatch.from_values(
                    batch.value(i).decode("utf-8", "replace").encode()
                    for i in range(batch.num_records))
        return batch


class RawTextInputFormat(TextInputFormat):
    """The split's owned bytes as ONE record, unparsed (the lines of
    :class:`TextInputFormat`'s rule with their newlines), for kernels that
    treat a newline as one more separator (``wordcount``).
    ``MAP_INPUT_RECORDS`` counts splits, not lines."""

    keep_bytes = True

    def read_batch(self, split: FileSplit, conf: Any) -> RecordBatch:
        buf = self._read_owned_bytes(split, conf)
        if not buf:
            return RecordBatch.empty()
        return RecordBatch(np.zeros(0, np.uint8), np.zeros(2, np.int32),
                           np.frombuffer(buf, dtype=np.uint8),
                           np.array([0, len(buf)], dtype=np.int32))


class BytesTextInputFormat(TextInputFormat):
    """:class:`TextInputFormat` whose values stay raw bytes."""

    keep_bytes = True


class KeyValueTextInputFormat(TextInputFormat):
    """Each line split at the first byte of
    ``key.value.separator.in.input.line`` (TAB by default, and where the
    value is empty) into (key, value); a line without it is (line, "").
    Its values are not the whole lines, so it reads no batches."""

    read_batch = None

    def get_record_reader(self, split: FileSplit, conf: Any,
                          reporter: Any = None) -> Iterator[tuple[str, str]]:
        sep = (str(conf.get("key.value.separator.in.input.line", "\t"))
               or "\t")[:1]
        for _offset, line in super().get_record_reader(split, conf,
                                                       reporter):
            k, _, v = line.partition(sep)
            yield k, v


class NLineInputFormat(FileInputFormat):
    """One split per ``mapred.line.input.format.linespermap`` lines (1 by
    default), each an exact line range. It has no ``read_batch``: its
    records reach a kernel through the record reader."""

    def get_splits(self, conf: Any, num_splits: int) -> list[InputSplit]:
        n = conf.get_int("mapred.line.input.format.linespermap", 1)
        splits: list[InputSplit] = []
        for fs, st in self.list_input_files(conf):
            with fs.open(st.path) as f:
                pos = begin = count = 0
                for line in f:
                    count += 1
                    pos += len(line)
                    if count == n:
                        splits.append(FileSplit(
                            _hosts(fs, st, begin, pos - begin),
                            str(st.path), begin, pos - begin))
                        begin, count = pos, 0
                if count:
                    splits.append(FileSplit(
                        _hosts(fs, st, begin, pos - begin), str(st.path),
                        begin, pos - begin))
        return splits

    def get_record_reader(self, split: FileSplit, conf: Any,
                          reporter: Any = None) -> Iterator[tuple[int, str]]:
        f = FileSystem.get(split.path, conf).open(split.path)
        f.seek(split.start)
        pos, end = split.start, split.start + split.split_length
        try:
            while pos < end:
                line = f.readline()
                if not line:
                    break
                yield pos, line.rstrip(b"\r\n").decode("utf-8", "replace")
                pos += len(line)
        finally:
            f.close()


class SequenceFileInputFormat(FileInputFormat):
    """Typed key/value records of SequenceFiles, each split read from the
    sync marker at or after its start (``sequencefile.Reader``)."""

    def get_record_reader(self, split: FileSplit, conf: Any,
                          reporter: Any = None) -> Iterator[tuple[Any, Any]]:
        f = FileSystem.get(split.path, conf).open(split.path)
        reader = sequencefile.Reader(f)

        def gen() -> Iterator[tuple[Any, Any]]:
            try:
                yield from reader.iter_range(split.start,
                                             split.start + split.length)
            finally:
                f.close()

        return gen()

    def read_batch(self, split: FileSplit, conf: Any) -> RecordBatch:
        """The whole split as one batch (``Reader.read_batch_range``)."""
        with FileSystem.get(split.path, conf).open(split.path) as f:
            return sequencefile.Reader(f).read_batch_range(
                split.start, split.start + split.length)


class WholeFileInputFormat(FileInputFormat):
    """One record a file, (path, its bytes); files are not split."""

    splittable = False

    def get_record_reader(self, split: FileSplit, conf: Any,
                          reporter: Any = None
                          ) -> Iterator[tuple[str, bytes]]:
        fs = FileSystem.get(split.path, conf)
        return iter([(split.path, fs.read_bytes(split.path))])


@dataclass
class MultiFileSplit(InputSplit):
    """Several whole-file chunks, each ``(path, start, length)``."""
    parts: list = field(default_factory=list)

    @property
    def length(self) -> int:
        return sum(p[2] for p in self.parts)


class CombineFileInputFormat(FileInputFormat):
    """Packs whole files into :class:`MultiFileSplit` s of at least
    ``mapred.max.split.size`` bytes (the total over the map count hint
    where that is unset); the records are :class:`TextInputFormat`'s."""

    def get_splits(self, conf: Any, num_splits: int) -> list[InputSplit]:
        files = self.list_input_files(conf)
        total = sum(st.length for _, st in files)
        target = conf.get_int("mapred.max.split.size", 2**63 - 1)
        if target in (0, 2**63 - 1):
            target = max(1, total // max(1, num_splits))
        splits: list[InputSplit] = []
        hosts: list[str] = []
        parts: list = []
        size = 0
        for fs, st in files:
            hosts += _hosts(fs, st, 0, st.length)
            parts.append((str(st.path), 0, st.length))
            size += st.length
            if size >= target:
                splits.append(MultiFileSplit(hosts, parts=parts))
                hosts, parts, size = [], [], 0
        if parts:
            splits.append(MultiFileSplit(hosts, parts=parts))
        return splits

    def get_record_reader(self, split: MultiFileSplit, conf: Any,
                          reporter: Any = None) -> Iterator[tuple[int, str]]:
        for path, start, length in split.parts:
            yield from LineRecordReader(FileSystem.get(path, conf), path,
                                        start, length)

    def read_batch(self, split: MultiFileSplit, conf: Any) -> RecordBatch:
        """Each part's :meth:`TextInputFormat.read_batch`, concatenated."""
        text = TextInputFormat()
        return RecordBatch.concat([
            text.read_batch(FileSplit([], path, start, length), conf)
            for path, start, length in split.parts])


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
                    n = min(per, rows - start)
                    splits.append(DenseSplit(
                        _hosts(fs, st, offset + start * row_bytes,
                               n * row_bytes), str(st.path), start, n,
                        row_bytes, dtype.str, cols, offset))
        return splits

    def get_record_reader(self, split: DenseSplit, conf: Any,
                          reporter: Any = None
                          ) -> Iterator[tuple[int, np.ndarray]]:
        """One (row id, row) record per row, each row a copy (a per-record
        mapper may write to it), for a per-record mapper such as
        ``MatmulCpuMapper``."""
        batch = self.read_batch(split, conf)
        return iter((int(i), np.array(row))
                    for i, row in zip(batch.ids, batch.values))

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
