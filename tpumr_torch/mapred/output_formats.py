"""Text output and the two-phase output commit.

Counterpart of ``TextOutputFormat`` and ``FileOutputCommitter`` in
``tpumr/mapred/output_formats.py``. Tasks write under
``$out/_temporary/<attempt>/``; a committed attempt's files move into
``$out``; the job commit writes ``_SUCCESS`` and removes ``_temporary``.
"""

from __future__ import annotations

from typing import Any

from tpumr_torch.fs.filesystem import FileSystem, Path

TEMP_DIR = "_temporary"
SUCCESS_MARKER = "_SUCCESS"


def part_name(partition: int) -> str:
    return f"part-{partition:05d}"


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


class TextOutputFormat:
    """key<TAB>value lines, one part file per reduce."""

    def get_record_writer(self, conf: Any, work_dir: str,
                          partition: int) -> _TextWriter:
        fs = FileSystem.get(work_dir, conf)
        sep = conf.get("mapred.textoutputformat.separator", "\t")
        return _TextWriter(fs.create(Path(work_dir).child(part_name(partition))),
                           sep)

    def check_output_specs(self, conf: Any) -> None:
        """Refuse to clobber an existing non-empty output directory."""
        out = conf.get("mapred.output.dir")
        if not out:
            raise ValueError("mapred.output.dir not set")
        fs = FileSystem.get(out, conf)
        if fs.exists(out) and (not fs.get_status(out).is_dir
                               or fs.list_status(out)):
            raise FileExistsError(f"output directory already exists: {out}")


class FileOutputCommitter:
    def __init__(self, conf: Any) -> None:
        self.out = conf.get("mapred.output.dir")
        self.fs = FileSystem.get(self.out, conf)

    def setup_job(self) -> None:
        self.fs.mkdirs(Path(self.out).child(TEMP_DIR))

    def commit_job(self) -> None:
        self.fs.delete(Path(self.out).child(TEMP_DIR), recursive=True)
        self.fs.write_bytes(Path(self.out).child(SUCCESS_MARKER), b"")

    def work_dir(self, attempt_id: str) -> str:
        return str(Path(self.out).child(TEMP_DIR).child(attempt_id))

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
