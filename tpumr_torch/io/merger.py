"""Bounded-fan-in multi-pass merging of sorted runs.

Counterpart of ``tpumr/io/merger.py``. Where there are more sorted runs
than ``io.sort.factor``, intermediate passes merge some of them into an
IFile run on local disk until one final merge of at most ``factor``
streams remains, so a merge never holds more than ``factor`` open streams
or heap entries.

Each pass merges the contiguous window of runs with the fewest raw bytes
(:func:`_min_window`, ties to the leftmost), and the new run takes the
window's place in the list. Equal keys therefore keep their run order
through every pass, and the output is byte-identical to one flat
``ifile.merge_sorted`` over the same runs. The first pass merges just
enough runs that every later pass, the final one included, runs at the
full factor (:func:`_pass_width`, as ``Merger.getPassFactor``). The JAX
package's ``merge:pass`` trace span is left out (the port has no tracing);
its counters stay.
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
from typing import Any, Callable, Iterable, Iterator

from tpumr_torch.io import ifile
from tpumr_torch.io.compress import get_codec
from tpumr_torch.io.writable import vint_bytes

#: counter names, the same strings as ``core.counters.TaskCounter``'s
MERGE_PASSES = "MERGE_PASSES"
MERGE_PASS_SEGMENTS = "MERGE_PASS_SEGMENTS"
FRAMEWORK_GROUP = "tpumr.TaskCounter"

#: raw bytes gathered before a run writer joins them into one block
_BLOCK_BYTES = 1 << 22


class DiskRun:
    """One merged run on local disk: a single-partition IFile whose
    payload is streamed back in chunks when it is read."""

    def __init__(self, path: str, codec: str, raw_length: int,
                 offset: int, length: int, records: int = 0) -> None:
        self.path = path
        self.codec = codec
        self.raw_length = raw_length
        self.offset = offset
        self.length = length
        self.records = records

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        return ifile.iter_chunked_segment(
            ifile.file_region_chunks(self.path, self.offset, self.length),
            self.codec)

    def close(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


def _frame(records: Iterable[tuple[bytes, bytes]],
           emit: Callable[[bytes], None]) -> int:
    """Frame ``records`` as an IFile block body, handing ``emit`` joined
    blocks of about :data:`_BLOCK_BYTES`; returns the record count."""
    n = acc = 0
    parts: "list[bytes]" = []
    append = parts.append
    for kb, vb in records:
        append(vint_bytes(len(kb)))
        append(kb)
        append(vint_bytes(len(vb)))
        append(vb)
        n += 1
        acc += len(kb) + len(vb) + 4
        if acc >= _BLOCK_BYTES:
            emit(b"".join(parts))
            parts.clear()
            acc = 0
    emit(b"".join(parts))
    return n


def _new_run_file(run_dir: str, prefix: str) -> "tuple[int, str]":
    os.makedirs(run_dir, exist_ok=True)
    return tempfile.mkstemp(prefix=f"{prefix}-", suffix=".run", dir=run_dir)


def _unlink_quietly(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def write_run(records: Iterable[tuple[bytes, bytes]], run_dir: str,
              codec: str = "none", prefix: str = "merge") -> DiskRun:
    """Drain sorted ``records`` into a single-partition IFile run in
    ``run_dir``, byte-identical to ``ifile.Writer`` with one partition,
    and return the streaming view over it. The run is held in memory
    until it is compressed whole."""
    fd, path = _new_run_file(run_dir, prefix)
    try:
        blocks: "list[bytes]" = []
        n = _frame(records, blocks.append)
        raw = vint_bytes(n) + b"".join(blocks)
        payload = get_codec(codec).compress(raw)
        with os.fdopen(fd, "wb") as f:
            f.write(ifile.MAGIC)
            f.write(struct.pack(">I", len(payload)))
            f.write(payload)
    except BaseException:
        _unlink_quietly(path)
        raise
    # the payload starts after the magic and its 4-byte length
    return DiskRun(path, codec, len(raw), offset=len(ifile.MAGIC) + 4,
                   length=len(payload), records=n)


def _padded_vint(value: int, width: int = 5) -> bytes:
    """A LEB128 vint padded to ``width`` bytes with 0x80 continuation
    bytes (a non-minimal encoding that decodes the same), so that a count
    written before it is known can be patched in place. Five bytes hold
    counts below 2**35."""
    out = bytearray()
    for _ in range(width - 1):
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    if value > 0x7F:
        raise ValueError("record count exceeds padded vint width")
    out.append(value)
    return bytes(out)


def write_run_streaming(records: Iterable[tuple[bytes, bytes]],
                        run_dir: str, prefix: str = "merge") -> DiskRun:
    """Write sorted ``records`` of any length straight to a run file in
    blocks of about 4 MB, never holding the run; uncompressed, since
    whole-block compression would need the whole payload. The payload
    length and the record count (a padded vint) are patched at the end;
    the file reads as a standard single-partition IFile segment."""
    fd, path = _new_run_file(run_dir, prefix)
    head = len(ifile.MAGIC) + 4
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(ifile.MAGIC)
            f.write(struct.pack(">I", 0))        # payload length, patched
            f.write(_padded_vint(0))             # record count, patched
            written = [5]

            def emit(block: bytes) -> None:
                f.write(block)
                written[0] += len(block)

            n = _frame(records, emit)
            raw_len = written[0]
            f.seek(head - 4)
            f.write(struct.pack(">I", raw_len))  # codec none: payload = raw
            f.write(_padded_vint(n))
    except BaseException:
        _unlink_quietly(path)
        raise
    return DiskRun(path, "none", raw_len, offset=head, length=raw_len,
                   records=n)


def _pass_width(n: int, factor: int, first_pass: bool) -> int:
    """Runs merged by a pass over ``n`` runs: the first pass takes just
    enough that every later pass is a full-factor merge, so the pass count
    is the least the factor allows."""
    if not first_pass or n <= factor:
        return factor
    mod = (n - 1) % (factor - 1)
    return factor if mod == 0 else mod + 1


def _min_window(runs: "list[Any]", width: int) -> int:
    """Start of the contiguous ``width``-run window with the fewest total
    raw bytes (``raw_length``, 0 where a run has none), the leftmost of
    equals."""
    sizes = [max(0, int(getattr(r, "raw_length", 0) or 0)) for r in runs]
    best_start, cur = 0, sum(sizes[:width])
    best = cur
    for start in range(1, len(runs) - width + 1):
        cur += sizes[start + width - 1] - sizes[start - 1]
        if cur < best:
            best, best_start = cur, start
    return best_start


class BoundedMerge:
    """A lazy bounded-fan-in merge over sorted runs.

    Iterating runs the intermediate passes (on-disk runs under
    ``run_dir``, or a directory of its own when None; each input closed
    once its pass is done) and then yields the final merge of at most
    ``factor`` streams. ``close()`` deletes the intermediate runs, and the
    directory where the merge made it. ``passes`` and ``max_fan_in`` say
    what was done; a ``reporter`` counts ``MERGE_PASSES`` and
    ``MERGE_PASS_SEGMENTS``."""

    def __init__(self, segments: "list[Iterable[tuple[bytes, bytes]]]",
                 sort_key: "Callable[[bytes], Any] | None",
                 factor: int, run_dir: "str | None" = None,
                 reporter: Any = None, prefix: str = "merge") -> None:
        self._segments = list(segments)
        self._sort_key = sort_key
        self.factor = max(2, int(factor))
        self._run_dir = run_dir
        self._own_dir: "str | None" = None
        self._reporter = reporter
        self._prefix = prefix
        self._made: "list[DiskRun]" = []
        self.passes = 0
        self.max_fan_in = 0

    def _dir(self) -> str:
        if self._run_dir is None:
            self._run_dir = self._own_dir = tempfile.mkdtemp(
                prefix="tpumr_torch-merge-")
        return self._run_dir

    def _one_pass(self, runs: "list[Any]", first: bool) -> None:
        width = _pass_width(len(runs), self.factor, first)
        start = _min_window(runs, width)
        batch = runs[start:start + width]
        run = write_run_streaming(ifile.merge_sorted(batch, self._sort_key),
                                  self._dir(), prefix=self._prefix)
        for seg in batch:
            close = getattr(seg, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — cleanup is best effort
                    pass
        self._made.append(run)
        runs[start:start + width] = [run]
        self.passes += 1
        self.max_fan_in = max(self.max_fan_in, width)
        if self._reporter is not None:
            self._reporter.incr_counter(FRAMEWORK_GROUP, MERGE_PASSES, 1)
            self._reporter.incr_counter(FRAMEWORK_GROUP,
                                        MERGE_PASS_SEGMENTS, width)

    def __iter__(self) -> Iterator[tuple[bytes, bytes]]:
        runs: "list[Any]" = list(self._segments)
        first = True
        while len(runs) > self.factor:
            self._one_pass(runs, first)
            first = False
        self.max_fan_in = max(self.max_fan_in, len(runs))
        return iter(ifile.merge_sorted(runs, self._sort_key))

    def close(self) -> None:
        for run in self._made:
            run.close()
        self._made = []
        if self._own_dir is not None:
            shutil.rmtree(self._own_dir, ignore_errors=True)
            self._own_dir = None
