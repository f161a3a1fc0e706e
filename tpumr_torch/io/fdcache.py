"""A pinned LRU of open read-only file descriptors.

Counterpart of ``tpumr/io/fdcache.py`` (``FdCache``, whole). The node
runner serves map-output chunks through it (``tasktracker.serve_chunk``):
a segment is read start to finish in bounded chunks, and each chunk is one
``os.pread`` on a cached descriptor, with no shared file position, so
concurrent fetches of one file need no lock around the read. An entry
evicted while another thread reads through it is marked dead, and the last
reader closes it. A writer that deletes or replaces a file calls
``invalidate(prefix)``, or a cached descriptor would go on serving the old
inode (the runner does so when it cleans up a job).
"""

from __future__ import annotations

import os
import threading


class FdCache:
    """LRU of open read-only fds keyed by path, safe for concurrent
    readers. ``invalidate(prefix)`` is the correctness lever for
    writers: any path that was replaced/unlinked MUST be invalidated or
    a cached fd keeps serving the old inode."""

    class _Ent:
        __slots__ = ("fd", "pins", "dead")

        def __init__(self, fd: int) -> None:
            self.fd = fd
            self.pins = 0
            self.dead = False

    def __init__(self, capacity: int = 64) -> None:
        self._cap = max(1, int(capacity))
        # insertion order = recency order (re-inserted on every hit)
        self._entries: "dict[str, FdCache._Ent]" = {}
        self._lock = threading.Lock()
        # bumped by every invalidate(): _pin's miss path opens OUTSIDE
        # the lock, so an invalidation landing between its open and its
        # insert would otherwise cache an fd of the just-replaced inode
        # — serving the OLD bytes forever
        self._epoch = 0
        self.opens = 0
        self.evictions = 0

    def pread(self, path: str, n: int, offset: int) -> bytes:
        ent = self._pin(path)
        try:
            return os.pread(ent.fd, n, offset)
        finally:
            self._unpin(ent)

    def _pin(self, path: str) -> "FdCache._Ent":
        for _attempt in range(8):
            with self._lock:
                ent = self._entries.pop(path, None)
                if ent is not None:
                    self._entries[path] = ent   # most-recently used again
                    ent.pins += 1
                    return ent
                epoch0 = self._epoch
            fd = os.open(path, os.O_RDONLY)
            close_now = None
            try:
                with self._lock:
                    ent = self._entries.get(path)
                    if ent is not None:
                        # lost an open race — use the cached fd, drop ours
                        ent.pins += 1
                        close_now = fd
                        return ent
                    if self._epoch != epoch0:
                        # an invalidate() ran while we were opening: our
                        # fd may reference the replaced/unlinked inode —
                        # caching it would serve stale bytes forever
                        close_now = fd
                        continue
                    return self._insert_locked(path, fd)
            finally:
                if close_now is not None:
                    try:
                        os.close(close_now)
                    except OSError:
                        pass
        # invalidation storm: open while HOLDING the lock, which excludes
        # invalidate() entirely — pathological path, never the fast one
        with self._lock:
            ent = self._entries.pop(path, None)
            if ent is not None:
                self._entries[path] = ent
                ent.pins += 1
                return ent
            return self._insert_locked(path, os.open(path, os.O_RDONLY))

    def _insert_locked(self, path: str, fd: int) -> "FdCache._Ent":
        self.opens += 1
        ent = FdCache._Ent(fd)
        ent.pins = 1
        self._entries[path] = ent
        while len(self._entries) > self._cap:
            victim_path = next(iter(self._entries))
            victim = self._entries.pop(victim_path)
            self.evictions += 1
            if victim.pins:
                victim.dead = True   # last unpin closes it
            else:
                try:
                    os.close(victim.fd)
                except OSError:
                    pass
        return ent

    def _unpin(self, ent: "FdCache._Ent") -> None:
        with self._lock:
            ent.pins -= 1
            if ent.dead and ent.pins == 0:
                try:
                    os.close(ent.fd)
                except OSError:
                    pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def invalidate(self, prefix: str = "") -> None:
        """Drop (and close) every cached fd whose path starts with
        ``prefix`` — callers unlink or atomically replace files, and a
        cached fd would otherwise keep serving the OLD inode (and pin a
        cleaned-up job's disk blocks). '' drops everything."""
        with self._lock:
            self._epoch += 1
            victims = [p for p in self._entries if p.startswith(prefix)] \
                if prefix else list(self._entries)
            for p in victims:
                ent = self._entries.pop(p)
                if ent.pins:
                    ent.dead = True
                else:
                    try:
                        os.close(ent.fd)
                    except OSError:
                        pass
