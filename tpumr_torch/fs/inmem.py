"""The in-memory filesystem, ``mem://``: files of this process only.

Counterpart of ``tpumr/fs/inmem.py``. A file exists once the stream that
``create`` returned is closed. Blocks are 4 MB, each placed on one of three
fake hosts by a crc32 of the path, so split plans and their locality hints
are the JAX package's.
"""

from __future__ import annotations

import threading
import time
import zlib
from io import BytesIO
from typing import BinaryIO

from tpumr_torch.fs.filesystem import BlockLocation, FileStatus, FileSystem, Path


class _MemWriter(BytesIO):
    def __init__(self, fs: "InMemoryFileSystem", key: str) -> None:
        super().__init__()
        self._fs = fs
        self._key = key

    def close(self) -> None:
        if not self.closed:
            with self._fs._lock:
                self._fs._files[self._key] = (self.getvalue(), time.time())
        super().close()


class InMemoryFileSystem(FileSystem):
    #: fake hosts, one per block, round-robin from crc32(path)
    fake_hosts: list[str] = ["host0", "host1", "host2"]
    block_size = 4 * 1024 * 1024

    def __init__(self) -> None:
        self._files: dict[str, tuple[bytes, float]] = {}
        self._dirs: set[str] = {"/"}
        self._lock = threading.RLock()

    @staticmethod
    def _key(path: "str | Path") -> str:
        return Path(path).path

    def _add_parents(self, key: str, inclusive: bool = False) -> None:
        parts = key.split("/")
        for i in range(1, len(parts) + (1 if inclusive else 0)):
            self._dirs.add("/".join(parts[:i]) or "/")

    def open(self, path: "str | Path") -> BinaryIO:
        with self._lock:
            ent = self._files.get(self._key(path))
        if ent is None:
            raise FileNotFoundError(str(path))
        return BytesIO(ent[0])

    def create(self, path: "str | Path") -> BinaryIO:
        key = self._key(path)
        with self._lock:
            self._add_parents(key)
        return _MemWriter(self, key)

    def exists(self, path: "str | Path") -> bool:
        key = self._key(path)
        with self._lock:
            return key in self._files or key in self._dirs

    def get_status(self, path: "str | Path") -> FileStatus:
        key = self._key(path)
        with self._lock:
            if key in self._files:
                data, mtime = self._files[key]
                return FileStatus(Path(f"mem://{key}"), length=len(data),
                                  block_size=self.block_size, mtime=mtime)
            if key in self._dirs:
                return FileStatus(Path(f"mem://{key}"), is_dir=True)
        raise FileNotFoundError(str(path))

    def list_status(self, path: "str | Path") -> list[FileStatus]:
        key = self._key(path).rstrip("/") or "/"
        prefix = "/" if key == "/" else key + "/"
        with self._lock:
            names = list(self._files) + list(self._dirs)
        children = {prefix + name[len(prefix):].split("/", 1)[0]
                    for name in names
                    if name != key and name.startswith(prefix)}
        return sorted((self.get_status(c) for c in children),
                      key=lambda s: str(s.path))

    def mkdirs(self, path: "str | Path") -> bool:
        with self._lock:
            self._add_parents(self._key(path), inclusive=True)
        return True

    def delete(self, path: "str | Path", recursive: bool = False) -> bool:
        key = self._key(path)
        with self._lock:
            if key in self._files:
                del self._files[key]
                return True
            if key not in self._dirs:
                return False
            files = [f for f in self._files if f.startswith(key + "/")]
            dirs = [d for d in self._dirs if d.startswith(key + "/")]
            if (files or dirs) and not recursive:
                raise OSError(f"directory not empty: {key}")
            for f in files:
                del self._files[f]
            self._dirs.difference_update(dirs)
            self._dirs.discard(key)
            return True

    def rename(self, src: "str | Path", dst: "str | Path") -> bool:
        s, d = self._key(src), self._key(dst)
        with self._lock:
            if s in self._files:
                self._files[d] = self._files.pop(s)
                self._add_parents(d)
                return True
            if s not in self._dirs:
                return False
            for f in [f for f in self._files if f.startswith(s + "/")]:
                self._files[d + f[len(s):]] = self._files.pop(f)
            for x in [x for x in self._dirs if x.startswith(s + "/")]:
                self._dirs.discard(x)
                self._dirs.add(d + x[len(s):])
            self._dirs.discard(s)
            self._add_parents(d, inclusive=True)
            return True

    def get_block_locations(self, path: "str | Path", offset: int,
                            length: int) -> list[BlockLocation]:
        """Block i of a file lives on ``fake_hosts[(crc32(path) + i) % 3]``,
        the same in every process."""
        key = self._key(path)
        base = zlib.crc32(key.encode())
        with self._lock:
            ent = self._files.get(key)
        end = min(offset + length,
                  len(ent[0]) if ent is not None else offset + length)
        bs = self.block_size
        hosts = self.fake_hosts
        out = [BlockLocation([hosts[(base + pos // bs) % len(hosts)]], pos,
                             min(bs, end - pos))
               for pos in range((offset // bs) * bs, end, bs)]
        return out or [BlockLocation([hosts[base % len(hosts)]], offset, 0)]


FileSystem.register("mem", InMemoryFileSystem)
