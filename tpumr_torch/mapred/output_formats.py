"""Text, SequenceFile and dense ``.npy`` output, and the two-phase output
commit.

Counterpart of ``TextOutputFormat``, ``SequenceFileOutputFormat``,
``DenseNpyOutputFormat``, ``NullOutputFormat`` and ``FileOutputCommitter`` in
``tpumr/mapred/output_formats.py``. Tasks write under
``$out/_temporary/<attempt>/``; a committed attempt's files move into
``$out``; the job commit writes ``_SUCCESS`` and removes ``_temporary``.
"""

from __future__ import annotations

import hashlib
import io
from typing import Any

import numpy as np

from tpumr_torch.fs.filesystem import FileSystem, Path
from tpumr_torch.io import sequencefile

TEMP_DIR = "_temporary"
SUCCESS_MARKER = "_SUCCESS"


def part_name(partition: int, prefix: str = "part") -> str:
    """``prefix`` names a side output (``lib.MultipleOutputs``); "part" is
    the job's main output."""
    return f"{prefix}-{partition:05d}"


class _TextWriter:
    def __init__(self, stream: Any, separator: str = "\t") -> None:
        self._f = stream
        self._sep = separator.encode()

    def write(self, key: Any, value: Any) -> None:
        def enc(x: Any) -> bytes:
            return x if isinstance(x, bytes) else str(x).encode("utf-8")
        if key is None:
            self._f.write(enc(value) + b"\n")
        else:
            self._f.write(enc(key) + self._sep + enc(value) + b"\n")

    def close(self) -> None:
        self._f.close()


class FileOutputFormat:
    """Output under ``mapred.output.dir``, one part file per task."""

    def check_output_specs(self, conf: Any) -> None:
        """Refuse to clobber an existing non-empty output directory."""
        out = conf.get("mapred.output.dir")
        if not out:
            raise ValueError("mapred.output.dir not set")
        fs = FileSystem.get(out, conf)
        if fs.exists(out) and (not fs.get_status(out).is_dir
                               or fs.list_status(out)):
            raise FileExistsError(f"output directory already exists: {out}")


class TextOutputFormat(FileOutputFormat):
    """key<TAB>value lines, one part file per reduce."""

    def get_record_writer(self, conf: Any, work_dir: str, partition: int,
                          prefix: str = "part") -> _TextWriter:
        fs = FileSystem.get(work_dir, conf)
        sep = conf.get("mapred.textoutputformat.separator", "\t")
        return _TextWriter(fs.create(Path(work_dir).child(
            part_name(partition, prefix))), sep)


class _SeqWriter:
    def __init__(self, stream: Any, codec: str) -> None:
        self._f = stream
        self._w = sequencefile.Writer(stream, codec=codec)

    def write(self, key: Any, value: Any) -> None:
        self._w.append(key, value)

    def write_fixed_rows(self, rows: np.ndarray, klen: int) -> None:
        """Fixed-width ``bytes`` records in bulk
        (``sequencefile.Writer.append_fixed_rows``)."""
        self._w.append_fixed_rows(rows, klen)

    def close(self) -> None:
        self._w.close()
        self._f.close()


class SequenceFileOutputFormat(FileOutputFormat):
    """One SequenceFile per task, block-compressed with
    ``mapred.output.compression.codec`` when ``mapred.output.compress`` is
    set."""

    def get_record_writer(self, conf: Any, work_dir: str, partition: int,
                          prefix: str = "part") -> _SeqWriter:
        fs = FileSystem.get(work_dir, conf)
        codec = conf.get("mapred.output.compression.codec", "none") \
            if conf.get_boolean("mapred.output.compress", False) else "none"
        return _SeqWriter(fs.create(Path(work_dir).child(
            part_name(partition, prefix))), codec)


class _DenseNpyWriter:
    """Collects a task's (row0, 2-D block) records into one ``.npy`` part
    file, rows in ``row0`` order, then publishes the task's offered device
    rows as the file's resident image (``device_output``)."""

    def __init__(self, conf: Any, fs: FileSystem, path: Path) -> None:
        self._conf = conf
        self._fs = fs
        self._path = path
        self._blocks: "list[tuple[int, np.ndarray]]" = []

    def write(self, key: Any, value: Any) -> None:
        self._blocks.append((int(key), np.asarray(value)))

    def close(self) -> None:
        self._blocks.sort(key=lambda b: b[0])
        arr = (np.concatenate([b[1] for b in self._blocks])
               if self._blocks else np.zeros((0, 0), np.float32))
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr))
        data = buf.getvalue()
        with self._fs.create(self._path) as f:
            f.write(data)
        from tpumr_torch.mapred import device_output
        rows = device_output.claim(
            str(self._conf.get("tpumr.task.attempt.id", "")))
        if (rows is not None and tuple(rows.shape) == arr.shape
                and device_output.numpy_dtype(rows.dtype) == arr.dtype):
            # the written file's mtime is part of the key; the commit
            # rename keeps it. Without it nothing is published: residency
            # is never needed for the file to be read
            try:
                mtime = self._fs.get_status(self._path).mtime
            except OSError:
                return
            head, tail, size = device_output.head_tail(data)
            device_output.publish(self._conf, rows, head, tail, size, mtime,
                                  full_sha=hashlib.sha1(data).hexdigest())

    def abort(self) -> None:
        """A failed attempt writes no file and publishes nothing."""
        self._blocks.clear()
        from tpumr_torch.mapred import device_output
        device_output.claim(str(self._conf.get("tpumr.task.attempt.id", "")))


class DenseNpyOutputFormat(FileOutputFormat):
    """Map-side dense output: records are ``(row0, 2-D block)``; each task
    writes ``part-NNNNN.npy``. A later ``DenseInputFormat`` job over the
    directory stages the blocks straight from the card where they are
    still resident."""

    #: the device runner offers a kernel's device rows only to a format
    #: that claims them
    claims_device_rows = True

    def get_record_writer(self, conf: Any, work_dir: str, partition: int,
                          prefix: str = "part") -> _DenseNpyWriter:
        fs = FileSystem.get(work_dir, conf)
        return _DenseNpyWriter(conf, fs, Path(work_dir).child(
            part_name(partition, prefix) + ".npy"))


class _NullWriter:
    def write(self, key: Any, value: Any) -> None:
        pass

    def close(self) -> None:
        pass


class NullOutputFormat:
    """Discards every record and checks nothing."""

    def get_record_writer(self, conf: Any, work_dir: str, partition: int,
                          prefix: str = "part") -> _NullWriter:
        return _NullWriter()

    def check_output_specs(self, conf: Any) -> None:
        pass


class FileOutputCommitter:
    def __init__(self, conf: Any) -> None:
        self.out = conf.get("mapred.output.dir")
        self.fs = FileSystem.get(self.out, conf)

    def setup_job(self) -> None:
        self.fs.mkdirs(Path(self.out).child(TEMP_DIR))

    def commit_job(self) -> None:
        self.fs.delete(Path(self.out).child(TEMP_DIR), recursive=True)
        self.fs.write_bytes(Path(self.out).child(SUCCESS_MARKER), b"")

    def abort_job(self) -> None:
        self.fs.delete(Path(self.out).child(TEMP_DIR), recursive=True)

    def work_dir(self, attempt_id: str) -> str:
        return str(Path(self.out).child(TEMP_DIR).child(attempt_id))

    def needs_commit(self, attempt_id: str) -> bool:
        """Whether the attempt wrote files to promote."""
        wd = self.work_dir(attempt_id)
        return self.fs.exists(wd) and bool(self.fs.list_files(wd))

    def setup_task(self, attempt_id: str) -> str:
        wd = self.work_dir(attempt_id)
        self.fs.mkdirs(wd)
        return wd

    def commit_task(self, attempt_id: str) -> None:
        """Move the attempt's files into $out (first writer wins per
        name)."""
        wd = self.work_dir(attempt_id)
        if not self.fs.exists(wd):
            return
        for st in self.fs.list_files(wd, recursive=True):
            dst = Path(self.out).child(st.path.name)
            if not self.fs.exists(dst):
                self.fs.rename(st.path, dst)
        self.fs.delete(wd, recursive=True)

    def abort_task(self, attempt_id: str) -> None:
        self.fs.delete(self.work_dir(attempt_id), recursive=True)
