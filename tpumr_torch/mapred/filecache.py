"""The job's file cache: an ordered list of files, localised per node with
their link names and executable bits, and reference-counted by job.

Counterpart of ``tpumr/mapred/filecache.py``, whole. The order of the list
is the contract the pipes tier rests on: the dual-executable submission
puts the CPU binary at index 0 and the GPU binary at index 1
(``pipes/submitter.setup_pipes_job``), and ``pipes/application`` takes
``files[1 if run_on_gpu else 0]`` (the reference's
``localCacheFiles[runOnGPU ? 1 : 0]``).

A file is copied once per node into ``<cache root>/<digest>/<link>``, the
digest a sha256 of its absolute path, mtime and size, so a rewritten file
is localised anew. A job holds one reference per entry, dropped when the
node runner cleans the job up (:func:`release_job`); an entry no job holds
is deleted. Entries marked executable keep the owner's and group's
execute bits.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import stat
import threading
from typing import Any

#: the ordered, comma-separated cache list; an entry may end in ``#link``
CACHE_FILES_KEY = "mapred.cache.files"
#: the entries localised with the execute bit set
CACHE_EXECUTABLES_KEY = "tpumr.cache.executables"

_lock = threading.Lock()
#: (cache root, digest) -> the jobs holding the entry
_refs: "dict[tuple[str, str], set[str]]" = {}


def add_cache_file(conf: Any, path: str, link: "str | None" = None,
                   executable: bool = False) -> None:
    """Append one file to the job's ordered cache list."""
    entry = f"{path}#{link}" if link else path
    cur = conf.get(CACHE_FILES_KEY, "") or ""
    conf.set(CACHE_FILES_KEY, f"{cur},{entry}" if cur else entry)
    if executable:
        ex = conf.get(CACHE_EXECUTABLES_KEY, "") or ""
        conf.set(CACHE_EXECUTABLES_KEY, f"{ex},{entry}" if ex else entry)


def get_cache_files(conf: Any) -> "list[str]":
    raw = conf.get(CACHE_FILES_KEY, "") or ""
    return [e for e in raw.split(",") if e]


def _split_entry(entry: str) -> "tuple[str, str]":
    if "#" in entry:
        path, link = entry.rsplit("#", 1)
        return path, link
    return entry, os.path.basename(entry)


def _digest(path: str) -> str:
    st = os.stat(path)
    h = hashlib.sha256(
        f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}".encode())
    return h.hexdigest()[:24]


def get_local_cache_files(conf: Any, cache_root: str,
                          job_id: str = "") -> "list[str]":
    """Localise the job's cache files (once per file) and return their
    local paths in list order."""
    out: "list[str]" = []
    executables = set((conf.get(CACHE_EXECUTABLES_KEY, "") or "").split(","))
    os.makedirs(cache_root, exist_ok=True)
    for entry in get_cache_files(conf):
        path, link = _split_entry(entry)
        if not os.path.exists(path):
            raise FileNotFoundError(f"cache file missing: {path}")
        d = _digest(path)
        local_dir = os.path.join(cache_root, d)
        local = os.path.join(local_dir, link)
        with _lock:
            if not os.path.exists(local):
                os.makedirs(local_dir, exist_ok=True)
                tmp = f"{local}.{os.getpid()}.tmp"
                shutil.copy2(path, tmp)
                os.replace(tmp, local)
            if entry in executables:
                os.chmod(local, os.stat(local).st_mode | stat.S_IXUSR
                         | stat.S_IXGRP)
            _refs.setdefault((cache_root, d), set()).add(job_id)
        out.append(local)
    return out


def release_job(conf: Any, cache_root: str, job_id: str = "") -> None:
    """Drop the job's references; an entry no job holds is deleted."""
    for entry in get_cache_files(conf):
        path, _ = _split_entry(entry)
        try:
            d = _digest(path)
        except OSError:
            continue
        with _lock:
            key = (cache_root, d)
            holders = _refs.get(key)
            if holders is None:
                continue
            holders.discard(job_id)
            if not holders:
                del _refs[key]
                shutil.rmtree(os.path.join(cache_root, d),
                              ignore_errors=True)
