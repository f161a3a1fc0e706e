"""The local filesystem, ``file://``.

Counterpart of ``tpumr/fs/local.py``.
"""

from __future__ import annotations

import os
import shutil
from typing import BinaryIO

from tpumr_torch.fs.filesystem import FileStatus, FileSystem, Path


class LocalFileSystem(FileSystem):

    @staticmethod
    def _local(path: "str | Path") -> str:
        return Path(path).path

    def open(self, path: "str | Path") -> BinaryIO:
        return open(self._local(path), "rb")

    def create(self, path: "str | Path") -> BinaryIO:
        p = self._local(path)
        os.makedirs(os.path.dirname(p) or "/", exist_ok=True)
        return open(p, "wb")

    def exists(self, path: "str | Path") -> bool:
        return os.path.exists(self._local(path))

    def get_status(self, path: "str | Path") -> FileStatus:
        p = self._local(path)
        st = os.stat(p)
        return FileStatus(path=Path(f"file://{p}"), length=st.st_size,
                          is_dir=os.path.isdir(p), mtime=st.st_mtime)

    def list_status(self, path: "str | Path") -> list[FileStatus]:
        p = self._local(path)
        return [self.get_status(Path(f"file://{p}").child(name))
                for name in sorted(os.listdir(p))]

    def mkdirs(self, path: "str | Path") -> bool:
        os.makedirs(self._local(path), exist_ok=True)
        return True

    def delete(self, path: "str | Path", recursive: bool = False) -> bool:
        p = self._local(path)
        if not os.path.exists(p):
            return False
        if not os.path.isdir(p):
            os.remove(p)
        elif recursive:
            shutil.rmtree(p)
        else:
            os.rmdir(p)
        return True

    def rename(self, src: "str | Path", dst: "str | Path") -> bool:
        s, d = self._local(src), self._local(dst)
        if not os.path.exists(s):
            return False
        os.makedirs(os.path.dirname(d) or "/", exist_ok=True)
        os.replace(s, d)
        return True


FileSystem.register("file", LocalFileSystem)
