"""FileSystem: scheme-dispatched paths, file status and block locations.

Counterpart of ``tpumr/fs/filesystem.py``, trimmed to what the port's job
paths use. The port has two schemes, ``file://`` (``tpumr_torch/fs/local.py``)
and ``mem://`` (``tpumr_torch/fs/inmem.py``); ``FileSystem.get`` raises for
any other.
"""

from __future__ import annotations

import fnmatch
import posixpath
import re
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, BinaryIO


class Path:
    """``scheme://authority/path`` or a bare ``/path``; normalised."""

    __slots__ = ("scheme", "authority", "path")

    def __init__(self, s: "str | Path", child: "str | None" = None) -> None:
        if isinstance(s, Path):
            self.scheme, self.authority, self.path = \
                s.scheme, s.authority, s.path
        else:
            m = re.match(r"^([A-Za-z][A-Za-z0-9+.-]*)://([^/]*)(/.*|$)", s)
            if m:
                self.scheme, self.authority = m.group(1), m.group(2)
                self.path = posixpath.normpath(m.group(3) or "/")
            else:
                self.scheme = self.authority = ""
                self.path = posixpath.normpath(s) if s else "/"
        if child is not None:
            self.path = posixpath.normpath(posixpath.join(self.path, child))

    def __str__(self) -> str:
        if self.scheme:
            return f"{self.scheme}://{self.authority}{self.path}"
        return self.path

    @property
    def name(self) -> str:
        return posixpath.basename(self.path)

    def child(self, name: str) -> "Path":
        return Path(str(self), name)


@dataclass
class FileStatus:
    path: Path
    length: int = 0
    is_dir: bool = False
    #: the split planner's block size (64 MB unless the filesystem says)
    block_size: int = 64 * 1024 * 1024
    mtime: float = field(default_factory=time.time)


@dataclass
class BlockLocation:
    """Hosts holding bytes [offset, offset + length) of a file: the
    locality hints a split carries."""
    hosts: list[str]
    offset: int
    length: int


class FileSystem(ABC):
    """Abstract filesystem; ``get`` returns the one for a URI's scheme."""

    _registry: dict[str, type] = {}
    _cache: dict[str, "FileSystem"] = {}

    @classmethod
    def register(cls, scheme: str, impl: type) -> None:
        cls._registry[scheme] = impl

    @classmethod
    def get(cls, uri: "str | Path", conf: Any = None) -> "FileSystem":
        scheme = Path(uri).scheme or "file"
        impl = cls._registry.get(scheme)
        if impl is None:
            raise ValueError(f"no FileSystem for scheme {scheme!r}; "
                             f"registered: {sorted(cls._registry)}")
        fs = cls._cache.get(scheme)
        if fs is None:
            fs = cls._cache[scheme] = impl()
        return fs

    @classmethod
    def clear_cache(cls) -> None:
        """Forget every instance (a ``mem://`` filesystem's files with it)."""
        cls._cache.clear()

    @abstractmethod
    def open(self, path: "str | Path") -> BinaryIO: ...

    @abstractmethod
    def create(self, path: "str | Path") -> BinaryIO: ...

    @abstractmethod
    def exists(self, path: "str | Path") -> bool: ...

    @abstractmethod
    def get_status(self, path: "str | Path") -> FileStatus: ...

    @abstractmethod
    def list_status(self, path: "str | Path") -> list[FileStatus]: ...

    @abstractmethod
    def mkdirs(self, path: "str | Path") -> bool: ...

    @abstractmethod
    def delete(self, path: "str | Path", recursive: bool = False) -> bool: ...

    @abstractmethod
    def rename(self, src: "str | Path", dst: "str | Path") -> bool: ...

    def get_block_locations(self, path: "str | Path", offset: int,
                            length: int) -> list[BlockLocation]:
        """One block on ``localhost``: a local filesystem places nothing."""
        return [BlockLocation(["localhost"], offset, length)]

    def glob_status(self, pattern: "str | Path") -> list[FileStatus]:
        """The files and directories matching ``pattern``, whose components
        may hold ``*``, ``?`` and ``[...]``, sorted by path."""
        pat = Path(pattern)
        base = Path(pat)
        base.path = "/"
        candidates = [base]
        for comp in [c for c in pat.path.split("/") if c]:
            nxt: list[Path] = []
            for c in candidates:
                if not re.search(r"[*?\[]", comp):
                    nxt.append(c.child(comp))
                elif self.exists(c) and self.get_status(c).is_dir:
                    nxt += [st.path for st in self.list_status(c)
                            if fnmatch.fnmatchcase(st.path.name, comp)]
            candidates = nxt
        return sorted((self.get_status(c) for c in candidates
                       if self.exists(c)), key=lambda s: str(s.path))

    def read_bytes(self, path: "str | Path") -> bytes:
        with self.open(path) as f:
            return f.read()

    def write_bytes(self, path: "str | Path", data: bytes) -> None:
        with self.create(path) as f:
            f.write(data)

    def list_files(self, path: "str | Path", recursive: bool = False
                   ) -> list[FileStatus]:
        out: list[FileStatus] = []
        for st in self.list_status(path):
            if not st.is_dir:
                out.append(st)
            elif recursive:
                out.extend(self.list_files(st.path, True))
        return out
