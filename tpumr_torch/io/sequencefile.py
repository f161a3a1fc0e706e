"""SequenceFile: the framework's splittable key/value container.

Counterpart of ``tpumr/io/sequencefile.py``, byte-compatible with it: each
package reads the other's files. A file is a header (magic ``TSEQ``,
version, the serialized metadata with its codec, a 16-byte sync marker
drawn from ``os.urandom``), then blocks (a uint32 length and the
compressed body: a vint record count, then per record the vint lengths and
serialized bytes of key and value), with an escape and the sync marker
before a block once ``SYNC_INTERVAL`` bytes have gone by since the last.
A reader can start at any byte offset: :meth:`Reader.sync` moves to the
next marker, which is what makes the file splittable. Two writes of the same
records differ only in their markers; compare decoded records, not bytes.
"""

from __future__ import annotations

import os
import struct
from io import BytesIO
from typing import Any, BinaryIO, Iterator

import numpy as np

from tpumr_torch.io.compress import get_codec
from tpumr_torch.io.recordbatch import RecordBatch, fixed_offsets
from tpumr_torch.io.writable import (_TAG_BYTES, deserialize, read_vint,
                                     serialize, vint_at, vint_bytes,
                                     write_vint)

MAGIC = b"TSEQ"
VERSION = 1
SYNC_SIZE = 16
SYNC_INTERVAL = 100 * SYNC_SIZE
_SYNC_ESCAPE = 0xFFFFFFFF   # uint32 length sentinel before a sync marker
_SCAN_CHUNK = 1 << 16


class Writer:
    """Buffers ``block_records`` records, then writes them as one
    (optionally compressed) block. The caller owns and closes the
    stream."""

    def __init__(self, stream: BinaryIO, codec: str = "none",
                 metadata: "dict[str, str] | None" = None,
                 block_records: int = 1000) -> None:
        self._out = stream
        self._codec = get_codec(codec)
        self._block_records = max(1, block_records)
        self._sync = os.urandom(SYNC_SIZE)
        self._buf: list[tuple[bytes, bytes]] = []
        self._since_sync = 0
        meta = dict(metadata or {})
        meta["codec"] = self._codec.name
        mb = serialize(meta)
        self._out.write(MAGIC + bytes((VERSION,)) + vint_bytes(len(mb)) + mb
                        + self._sync)

    def append(self, key: Any, value: Any) -> None:
        self.append_raw(serialize(key), serialize(value))

    def append_raw(self, kbytes: bytes, vbytes: bytes) -> None:
        self._buf.append((kbytes, vbytes))
        if len(self._buf) >= self._block_records:
            self._flush_block()

    def _flush_block(self) -> None:
        if not self._buf:
            return
        body = BytesIO()
        write_vint(body, len(self._buf))
        for k, v in self._buf:
            write_vint(body, len(k))
            body.write(k)
            write_vint(body, len(v))
            body.write(v)
        self._emit_block(body.getvalue())
        self._buf.clear()

    def _emit_block(self, body: bytes) -> None:
        payload = self._codec.compress(body)
        if self._since_sync >= SYNC_INTERVAL:
            self._out.write(struct.pack(">I", _SYNC_ESCAPE))
            self._out.write(self._sync)
            self._since_sync = 0
        self._out.write(struct.pack(">I", len(payload)))
        self._out.write(payload)
        self._since_sync += len(payload) + 4

    def append_fixed_rows(self, rows: np.ndarray, klen: int) -> None:
        """Append ``rows`` (``[n, klen + vlen] uint8``, the key first) as
        ``bytes`` keys and values: the same bytes as ``n`` calls of
        ``append(key, value)``, framed by numpy. Every frame's lengths are
        the same, so the frames are one ``[n, frame]`` array written one
        block at a time."""
        n = int(rows.shape[0])
        if n == 0:
            return
        self._flush_block()   # records appended one by one go first
        vlen = int(rows.shape[1]) - klen

        def field_prefix(length: int) -> bytes:
            # vint(len(serialized)) ++ tag ++ vint(length): all but the
            # payload of one serialized bytes field
            tagged = _TAG_BYTES + vint_bytes(length)
            return vint_bytes(len(tagged) + length) + tagged

        kf = np.frombuffer(field_prefix(klen), np.uint8)
        vf = np.frombuffer(field_prefix(vlen), np.uint8)
        off = len(kf) + klen
        per = self._block_records
        for lo in range(0, n, per):
            m = min(per, n - lo)
            # one block's frames at a time: a whole-range frame array would
            # double the peak memory of the largest writes
            frames = np.empty((m, off + len(vf) + vlen), np.uint8)
            frames[:, :len(kf)] = kf
            frames[:, len(kf):off] = rows[lo:lo + m, :klen]
            frames[:, off:off + len(vf)] = vf
            frames[:, off + len(vf):] = rows[lo:lo + m, klen:]
            self._emit_block(vint_bytes(m) + frames.tobytes())

    def sync_now(self) -> None:
        """Flush and write a sync marker: a split boundary here."""
        self._flush_block()
        self._out.write(struct.pack(">I", _SYNC_ESCAPE))
        self._out.write(self._sync)
        self._since_sync = 0

    def close(self) -> None:
        """Flush pending records. The caller owns (and closes) the
        stream."""
        self._flush_block()
        self._out.flush()


def _parse_fixed_block(body: bytes
                       ) -> "tuple[np.ndarray, np.ndarray] | None":
    """``(keys [n, klen], values [n, vlen])`` as views of ``body`` when
    every record's frame outside its two payloads is the first record's
    (``bytes`` keys and values of one width each: the terasort layout);
    else None, and the caller parses record by record."""
    try:
        n, rec0 = vint_at(body, 0)
        if n <= 0:
            return None
        kser_len, kser0 = vint_at(body, rec0)
        if body[kser0] != _TAG_BYTES[0]:
            return None
        klen, kpay0 = vint_at(body, kser0 + 1)
        if kser0 + kser_len != kpay0 + klen:
            return None
        vser_len, vser0 = vint_at(body, kpay0 + klen)
        if body[vser0] != _TAG_BYTES[0]:
            return None
        vlen, vpay0 = vint_at(body, vser0 + 1)
        if vser0 + vser_len != vpay0 + vlen:
            return None
    except IndexError:
        return None
    frame = vpay0 + vlen - rec0
    if len(body) - rec0 != n * frame:
        return None
    arr = np.frombuffer(body, np.uint8, n * frame, rec0).reshape(n, frame)
    kpay = kpay0 - rec0
    vhdr = kpay + klen
    vpay = vpay0 - rec0
    meta_idx = np.concatenate([np.arange(0, kpay), np.arange(vhdr, vpay)])
    if n > 1 and not (arr[1:, meta_idx] == arr[0, meta_idx]).all():
        return None
    return arr[:, kpay:kpay + klen], arr[:, vpay:vpay + vlen]


def _as_bytes(x: Any) -> bytes:
    """A record field as the batch holds it: bytes as they are, text as
    UTF-8, anything else serialized (the JAX package's rule)."""
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    return x.encode("utf-8") if isinstance(x, str) else serialize(x)


class Reader:
    """Reads a file from its start or from any byte offset: a split
    ``[start, end)`` owns the blocks from the first sync marker whose
    escape lies at or after ``start`` up to the first at or after
    ``end``, so covering splits read every record once."""

    def __init__(self, stream: BinaryIO) -> None:
        self._in = stream
        if self._in.read(len(MAGIC)) != MAGIC:
            raise ValueError("not a tpumr SequenceFile (bad magic)")
        version = self._in.read(1)[0]
        if version != VERSION:
            raise ValueError(f"unsupported SequenceFile version {version}")
        mlen = read_vint(self._in)
        self.metadata: dict[str, str] = deserialize(self._in.read(mlen))
        self._codec = get_codec(self.metadata.get("codec", "none"))
        self._sync = self._in.read(SYNC_SIZE)
        self._header_end = self._in.tell()

    def __iter__(self) -> Iterator[tuple[Any, Any]]:
        for k, v in self.iter_raw():
            yield deserialize(k), deserialize(v)

    def _position_for_range(self, start: int, end: int) -> bool:
        """Seek to the first block of split ``[start, end)``; False when it
        owns nothing."""
        if end <= self._header_end:
            # the header's marker is the file's first boundary: its owner
            # is the split that starts at or before it
            return False
        if not self.sync(start):
            return False
        if start > self._header_end:
            boundary = self._in.tell() - SYNC_SIZE - 4
            if boundary >= end:
                return False
        return True

    def iter_range(self, start: int, end: int) -> Iterator[tuple[Any, Any]]:
        """The records of split ``[start, end)``, deserialized."""
        if not self._position_for_range(start, end):
            return
        for k, v in self.iter_raw(end=end):
            yield deserialize(k), deserialize(v)

    def iter_block_bodies(self, end: "int | None" = None) -> Iterator[bytes]:
        """Decompressed block bodies from here, up to the first sync
        marker whose escape lies at or after ``end``."""
        while True:
            pos = self._in.tell()
            raw = self._in.read(4)
            if len(raw) < 4:
                return
            (length,) = struct.unpack(">I", raw)
            if length == _SYNC_ESCAPE:
                if self._in.read(SYNC_SIZE) != self._sync:
                    raise IOError("corrupt file: bad sync marker")
                if end is not None and pos >= end:
                    return
                continue
            payload = self._in.read(length)
            if len(payload) < length:
                raise EOFError("truncated block")
            yield self._codec.decompress(payload)

    def iter_raw(self, end: "int | None" = None
                 ) -> Iterator[tuple[bytes, bytes]]:
        for body in self.iter_block_bodies(end):
            block = BytesIO(body)
            for _ in range(read_vint(block)):
                k = block.read(read_vint(block))
                v = block.read(read_vint(block))
                yield k, v

    def read_batch_range(self, start: int, end: int) -> RecordBatch:
        """The records of split ``[start, end)`` as one
        :class:`RecordBatch`. Fixed-width ``bytes`` blocks parse as a numpy
        reshape each; once a block does not, every record is parsed one by
        one, in order, with ``_as_bytes`` fields."""
        if not self._position_for_range(start, end):
            return RecordBatch.empty()
        key_chunks: list[np.ndarray] = []
        val_chunks: list[np.ndarray] = []
        slow: list[tuple[bytes, bytes]] = []
        for body in self.iter_block_bodies(end):
            if body[:1] == b"\x00":   # an empty block
                continue
            if not slow:
                parsed = _parse_fixed_block(body)
                if parsed is not None and key_chunks and (
                        parsed[0].shape[1] != key_chunks[0].shape[1]
                        or parsed[1].shape[1] != val_chunks[0].shape[1]):
                    parsed = None     # the widths changed between blocks
                if parsed is not None:
                    key_chunks.append(parsed[0])
                    val_chunks.append(parsed[1])
                    continue
                for karr, varr in zip(key_chunks, val_chunks):
                    slow.extend((karr[i].tobytes(), varr[i].tobytes())
                                for i in range(karr.shape[0]))
                key_chunks, val_chunks = [], []
            block = BytesIO(body)
            for _ in range(read_vint(block)):
                k = deserialize(block.read(read_vint(block)))
                v = deserialize(block.read(read_vint(block)))
                slow.append((_as_bytes(k), _as_bytes(v)))
        if slow:
            return RecordBatch.from_pairs(slow)
        if not key_chunks:
            return RecordBatch.empty()
        keys = np.concatenate(key_chunks)
        del key_chunks
        vals = np.concatenate(val_chunks)
        n = keys.shape[0]
        return RecordBatch(keys.reshape(-1), fixed_offsets(n, keys.shape[1]),
                           vals.reshape(-1), fixed_offsets(n, vals.shape[1]))

    def sync(self, pos: int) -> bool:
        """Move just past the first sync marker whose escape lies at or
        after ``pos`` (the marker itself at or after ``pos + 4``, so a
        split's end and the next split's start agree on every boundary).
        False when no marker follows. Scans in chunks of 64 KiB."""
        if pos <= self._header_end:
            self._in.seek(self._header_end)
            return True
        base = pos + 4
        self._in.seek(base)
        window = b""
        while True:
            chunk = self._in.read(_SCAN_CHUNK)
            if not chunk:
                return False
            window += chunk
            at = window.find(self._sync)
            if at >= 0:
                self._in.seek(base + at + SYNC_SIZE)
                return True
            keep = min(len(window), SYNC_SIZE - 1)
            base += len(window) - keep
            window = window[len(window) - keep:]

    def tell(self) -> int:
        return self._in.tell()
