"""IFile: the map-output spill format, and the k-way merge over segments.

Counterpart of ``tpumr/io/ifile.py``, trimmed to uncompressed segments (the
K-Means job does not compress map output). The file layout is the JAX
package's: ``TIFL`` magic, then per partition a big-endian u32 length and a
block holding a record count and length-prefixed key/value bytes. The index
``{"codec": "none", "partitions": [(offset, raw_length, part_length)]}``
addresses one partition's segment without parsing the rest; a node
runner serves that segment's bytes to a remote reduce as they lie on disk
(:func:`partition_bytes`), which parses them back
(:func:`iter_transferred_segment`).
"""

from __future__ import annotations

import heapq
import struct
from typing import Any, BinaryIO, Callable, Iterable, Iterator

from tpumr_torch.io.writable import vint_at, vint_into

MAGIC = b"TIFL"


class Writer:
    """Writes one spill file: partitions in order, each a block of sorted
    records. Call ``start_partition`` / ``append_raw`` / ``end_partition``,
    then ``close`` for the index."""

    def __init__(self, stream: BinaryIO) -> None:
        self._out = stream
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
        self._out.write(struct.pack(">I", len(raw)))
        self._out.write(raw)
        self._partitions.append((self._pos, len(raw), len(raw) + 4))
        self._pos += len(raw) + 4
        self._buf = None

    def close(self) -> dict:
        self._out.flush()
        return {"codec": "none", "partitions": list(self._partitions)}


def read_partition(path: str, index: dict, partition: int
                   ) -> Iterator[tuple[bytes, bytes]]:
    """One partition's records from a spill file, given its index."""
    if index.get("codec", "none") != "none":
        raise ValueError(f"compressed map output ({index['codec']}) is not "
                         "supported by the port")
    off, _raw_len, _part_len = index["partitions"][partition]
    with open(path, "rb") as f:
        f.seek(off)
        (plen,) = struct.unpack(">I", f.read(4))
        raw = f.read(plen)
    return iter_segment(raw)


def partition_bytes(stream: BinaryIO, index: dict, partition: int) -> bytes:
    """One partition's segment as it lies on disk (the u32 length and the
    block), for the shuffle server to send verbatim."""
    off, _raw_len, part_len = index["partitions"][partition]
    stream.seek(off)
    return stream.read(part_len)


def iter_transferred_segment(data: bytes, codec: str = "none"
                             ) -> Iterator[tuple[bytes, bytes]]:
    """The records of a segment as :func:`partition_bytes` gave it."""
    if codec != "none":
        raise ValueError(f"compressed map output ({codec}) is not "
                         "supported by the port")
    (plen,) = struct.unpack(">I", data[:4])
    return iter_segment(data[4:4 + plen])


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


def merge_sorted(segments: "list[Iterable[tuple[bytes, bytes]]]",
                 sort_key: Callable[[bytes], Any]
                 ) -> Iterator[tuple[bytes, bytes]]:
    """K-way merge of sorted (key, value) streams. Stable: equal keys come
    out in segment order, as in the JAX package's merge."""
    return heapq.merge(*segments, key=lambda kv: sort_key(kv[0]))
