"""IFile: the map-output spill format, and the k-way merge over segments.

Counterpart of ``tpumr/io/ifile.py``. The file layout is the JAX
package's: ``TIFL`` magic, then per partition a big-endian u32 length and
a payload, the partition's block compressed whole by the file's codec
(``none`` by default, ``mapred.compress.map.output`` on the map side). A
block holds a record count and length-prefixed key/value bytes. The index
``{"codec": name, "partitions": [(offset, raw_length, part_length)]}``
addresses one partition's segment without parsing the rest; a node runner
serves that segment's bytes to a remote reduce as they lie on disk
(:func:`partition_bytes`), which parses them back
(:func:`iter_transferred_segment`). A merge reads a segment straight from
its file in bounded chunks (:func:`file_region_chunks`), through the
codec's streaming decompressor (:func:`iter_chunked_segment`), so no
segment is ever held whole. The merges (``:244-343`` there):
:func:`merge_sorted`, lazy, with the raw-key fast path
(:func:`is_raw_sort_key`, :func:`_merge_two_raw`), and
:func:`merge_sorted_inmem` for segments held in memory; all give the JAX
package's bytes, equal keys in segment order.
"""

from __future__ import annotations

import heapq
import struct
from itertools import chain
from operator import itemgetter
from typing import Any, BinaryIO, Callable, Iterable, Iterator

from tpumr_torch.io.compress import get_codec
from tpumr_torch.io.writable import vint_at, vint_into

MAGIC = b"TIFL"


class Writer:
    """Writes one spill file: partitions in order, each a block of sorted
    records, compressed whole by ``codec``. Call ``start_partition`` /
    ``append_raw`` / ``end_partition``, then ``close`` for the index."""

    def __init__(self, stream: BinaryIO, codec: str = "none") -> None:
        self._out = stream
        self._codec = get_codec(codec)
        self._out.write(MAGIC)
        self._pos = len(MAGIC)
        self._partitions: list[tuple[int, int, int]] = []
        self._buf: "bytearray | None" = None
        self._nrec = 0

    def start_partition(self) -> None:
        if self._buf is not None:
            raise RuntimeError("partition already open")
        self._buf = bytearray()
        self._nrec = 0

    def append_raw(self, kbytes: bytes, vbytes: bytes) -> None:
        if self._buf is None:
            raise RuntimeError("start_partition first")
        vint_into(self._buf, len(kbytes))
        self._buf += kbytes
        vint_into(self._buf, len(vbytes))
        self._buf += vbytes
        self._nrec += 1

    def end_partition(self) -> None:
        if self._buf is None:
            raise RuntimeError("no partition open")
        head = bytearray()
        vint_into(head, self._nrec)
        raw = bytes(head) + bytes(self._buf)
        payload = self._codec.compress(raw)
        self._out.write(struct.pack(">I", len(payload)))
        self._out.write(payload)
        self._partitions.append((self._pos, len(raw), len(payload) + 4))
        self._pos += len(payload) + 4
        self._buf = None

    def close(self) -> dict:
        self._out.flush()
        return {"codec": self._codec.name,
                "partitions": list(self._partitions)}


def read_partition(path: str, index: dict, partition: int
                   ) -> Iterator[tuple[bytes, bytes]]:
    """One partition's records from a spill file, given its index (the
    whole segment read at once)."""
    off, _raw_len, _part_len = index["partitions"][partition]
    with open(path, "rb") as f:
        f.seek(off)
        (plen,) = struct.unpack(">I", f.read(4))
        payload = f.read(plen)
    codec = get_codec(index.get("codec", "none"))
    return iter_segment(codec.decompress(payload))


def partition_bytes(stream: BinaryIO, index: dict, partition: int) -> bytes:
    """One partition's segment as it lies on disk (the u32 length and the
    payload), for the shuffle server to send verbatim."""
    off, _raw_len, part_len = index["partitions"][partition]
    stream.seek(off)
    return stream.read(part_len)


def iter_transferred_segment(data: bytes, codec: str = "none"
                             ) -> Iterator[tuple[bytes, bytes]]:
    """The records of a segment as :func:`partition_bytes` gave it,
    decoded by the map output's ``codec``."""
    (plen,) = struct.unpack(">I", data[:4])
    return iter_segment(get_codec(codec).decompress(data[4:4 + plen]))


def iter_segment(raw: bytes) -> Iterator[tuple[bytes, bytes]]:
    try:
        n, pos = vint_at(raw, 0)
        for _ in range(n):
            klen, pos = vint_at(raw, pos)
            k = raw[pos:pos + klen]
            pos += klen
            vlen, pos = vint_at(raw, pos)
            v = raw[pos:pos + vlen]
            pos += vlen
            if len(v) != vlen:
                raise EOFError("truncated segment")
            yield k, v
    except IndexError:
        raise EOFError("truncated segment") from None


def iter_chunked_segment(chunks: Iterable[bytes], codec: str
                         ) -> Iterator[tuple[bytes, bytes]]:
    """The records of one segment's payload (no length prefix) streamed as
    compressed chunks. At most one chunk's decompressed bytes, and the tail
    of a record that straddles two, are held at a time."""
    dec = get_codec(codec).decompressor()
    it = iter(chunks)
    buf = b""
    pos = 0
    eof = False

    def ensure(need: int) -> None:
        """Grow ``buf`` until ``need`` bytes remain past ``pos``."""
        nonlocal buf, pos, eof
        while len(buf) - pos < need:
            if eof:
                raise EOFError("truncated segment stream")
            piece = next(it, None)
            if piece is None:
                eof = True
            out = dec.flush() if piece is None else dec.feed(piece)
            if out:
                buf = buf[pos:] + out
                pos = 0

    def vint() -> int:
        nonlocal pos
        shift = result = 0
        while True:
            if pos >= len(buf):
                ensure(1)
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    n = vint()
    for _ in range(n):
        klen = vint()
        ensure(klen)
        k = buf[pos:pos + klen]
        pos += klen
        vlen = vint()
        ensure(vlen)
        v = buf[pos:pos + vlen]
        pos += vlen
        yield k, v


def file_region_chunks(path: str, offset: int, length: int,
                       chunk_bytes: int = 1 << 18) -> Iterator[bytes]:
    """A byte region of a local file in chunks of at most ``chunk_bytes``.
    The file is opened for each chunk and closed before the chunk is
    yielded: a merge keeps one such stream open per segment, and a wide
    merge must not hold a descriptor for each."""
    pos = offset
    remaining = length
    while remaining > 0:
        with open(path, "rb") as f:
            f.seek(pos)
            piece = f.read(min(chunk_bytes, remaining))
        if not piece:
            raise EOFError(f"truncated spill file {path}")
        pos += len(piece)
        remaining -= len(piece)
        yield piece


#: the raw-key fast path's key: a C getter, no Python frame a comparison
_KEY0 = itemgetter(0)

#: two distinct probe keys for :func:`is_raw_sort_key`: identity must hold
#: on both (a function that returns one fixed object passes one)
_PROBE_A = b"\x00\xff tpumr-raw-probe"
_PROBE_B = b"z"


def is_raw_sort_key(sort_key: "Callable[[bytes], Any] | None") -> bool:
    """True where ``sort_key`` orders key bytes as the bytes themselves
    (``RawComparator``: ``sort_key(k) is k``), probed on two keys; None
    counts as raw."""
    if sort_key is None:
        return True
    try:
        return (sort_key(_PROBE_A) is _PROBE_A
                and sort_key(_PROBE_B) is _PROBE_B)
    except Exception:  # noqa: BLE001 — a picky comparator is not raw
        return False


def _merge_two_raw(a: "Iterator[tuple[bytes, bytes]]",
                   b: "Iterator[tuple[bytes, bytes]]"
                   ) -> Iterator[tuple[bytes, bytes]]:
    """Two raw-key streams merged with one bytes comparison a record and
    no heap. Equal keys come from ``a`` first, as ``heapq.merge`` gives
    them, so both paths give the same bytes."""
    try:
        ka, va = next(a)
    except StopIteration:
        yield from b
        return
    try:
        kb, vb = next(b)
    except StopIteration:
        yield ka, va
        yield from a
        return
    while True:
        if ka <= kb:
            yield ka, va
            try:
                ka, va = next(a)
            except StopIteration:
                yield kb, vb
                yield from b
                return
        else:
            yield kb, vb
            try:
                kb, vb = next(b)
            except StopIteration:
                yield ka, va
                yield from a
                return


def merge_sorted(segments: "list[Iterable[tuple[bytes, bytes]]]",
                 sort_key: "Callable[[bytes], Any] | None"
                 ) -> Iterator[tuple[bytes, bytes]]:
    """K-way merge of sorted (key, value) streams, ordered by
    ``sort_key`` of the key bytes. Stable: equal keys come out in segment
    order, as in the JAX package's merge. Where ``sort_key`` is the
    identity on bytes (:func:`is_raw_sort_key`) the merge compares the raw
    keys through ``itemgetter(0)``, and two segments take
    :func:`_merge_two_raw`; every path gives the same bytes."""
    if not segments:
        return iter(())
    if len(segments) == 1:
        return iter(segments[0])
    if is_raw_sort_key(sort_key):
        if len(segments) == 2:
            return _merge_two_raw(iter(segments[0]), iter(segments[1]))
        return heapq.merge(*segments, key=_KEY0)
    return heapq.merge(*segments, key=lambda kv: sort_key(kv[0]))


def merge_sorted_inmem(segments: "list[Iterable[tuple[bytes, bytes]]]",
                       sort_key: "Callable[[bytes], Any] | None"
                       ) -> "list[tuple[bytes, bytes]]":
    """The merge of segments already in memory, as one list: the runs
    chained and sorted by Timsort, whose run detection merges them in C.
    The sort is stable, so equal keys keep segment order, the bytes of
    :func:`merge_sorted`. The caller bounds the input (the shuffle's merge
    manager merges within its RAM budget)."""
    records = list(chain.from_iterable(segments))
    if is_raw_sort_key(sort_key):
        records.sort(key=_KEY0)
    else:
        records.sort(key=lambda kv: sort_key(kv[0]))
    return records
