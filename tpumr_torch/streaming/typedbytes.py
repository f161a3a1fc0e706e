"""Typed bytes: the binary-safe wire format of streaming's ``-io
typedbytes``.

Counterpart of ``tpumr/streaming/typedbytes.py``, frame for frame: a value
is a 1-byte type code and a big-endian payload, so keys and values may
hold any bytes (newlines, tabs, NULs) that the line protocol cannot carry.

====  =========  ==========================================
code  type       payload
====  =========  ==========================================
0     BYTES      int32 length + raw bytes
1     BYTE       1 signed byte
2     BOOL       1 byte (0/1)
3     INT        int32 big-endian
4     LONG       int64 big-endian
5     FLOAT      IEEE-754 float32 big-endian
6     DOUBLE     IEEE-754 float64 big-endian
7     STRING     int32 length + UTF-8 bytes
8     VECTOR     int32 count + that many typed values
9     LIST       typed values until a MARKER byte
10    MAP        int32 count + count × (typed key, typed value)
255   MARKER     (terminates LIST)
====  =========  ==========================================

Written: bytes as BYTES, bool as BOOL, int as INT where it fits 32 bits
else LONG, float as DOUBLE, str as STRING, tuple as VECTOR, list as LIST,
dict as MAP. Read: BYTE as int, FLOAT as float, VECTOR as tuple, LIST as
list.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Iterator

BYTES, BYTE, BOOL, INT, LONG, FLOAT, DOUBLE, STRING = range(8)
VECTOR, LIST, MAP = 8, 9, 10
MARKER = 255

_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class TypedBytesError(ValueError):
    pass


def write_typed(out: BinaryIO, obj: Any) -> None:
    """Write one typed value."""
    if isinstance(obj, bool):  # before int: bool is an int subclass
        out.write(bytes((BOOL, 1 if obj else 0)))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.write(struct.pack(">Bi", BYTES, len(b)))
        out.write(b)
    elif isinstance(obj, int):
        if _INT32_MIN <= obj <= _INT32_MAX:
            out.write(struct.pack(">Bi", INT, obj))
        else:
            out.write(struct.pack(">Bq", LONG, obj))
    elif isinstance(obj, float):
        out.write(struct.pack(">Bd", DOUBLE, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.write(struct.pack(">Bi", STRING, len(b)))
        out.write(b)
    elif isinstance(obj, tuple):
        out.write(struct.pack(">Bi", VECTOR, len(obj)))
        for el in obj:
            write_typed(out, el)
    elif isinstance(obj, list):
        out.write(bytes((LIST,)))
        for el in obj:
            write_typed(out, el)
        out.write(bytes((MARKER,)))
    elif isinstance(obj, dict):
        out.write(struct.pack(">Bi", MAP, len(obj)))
        for k, v in obj.items():
            write_typed(out, k)
            write_typed(out, v)
    else:
        raise TypedBytesError(
            f"no typed-bytes encoding for {type(obj).__name__}")


def write_pair(out: BinaryIO, key: Any, value: Any) -> None:
    write_typed(out, key)
    write_typed(out, value)


def _read_exact(inp: BinaryIO, n: int) -> bytes:
    data = inp.read(n)
    if data is None or len(data) != n:
        raise EOFError("typed-bytes stream truncated")
    return data


def read_typed(inp: BinaryIO) -> Any:
    """Read one typed value; EOFError at a clean end of stream,
    TypedBytesError on an unknown code."""
    head = inp.read(1)
    if not head:
        raise EOFError("end of typed-bytes stream")
    return _read_body(inp, head[0])


def _read_body(inp: BinaryIO, code: int) -> Any:
    """Payload for an already-consumed type code."""
    if code == BYTES:
        (n,) = struct.unpack(">i", _read_exact(inp, 4))
        return _read_exact(inp, n)
    if code == BYTE:
        return struct.unpack(">b", _read_exact(inp, 1))[0]
    if code == BOOL:
        return _read_exact(inp, 1)[0] != 0
    if code == INT:
        return struct.unpack(">i", _read_exact(inp, 4))[0]
    if code == LONG:
        return struct.unpack(">q", _read_exact(inp, 8))[0]
    if code == FLOAT:
        return struct.unpack(">f", _read_exact(inp, 4))[0]
    if code == DOUBLE:
        return struct.unpack(">d", _read_exact(inp, 8))[0]
    if code == STRING:
        (n,) = struct.unpack(">i", _read_exact(inp, 4))
        return _read_exact(inp, n).decode("utf-8")
    if code == VECTOR:
        (n,) = struct.unpack(">i", _read_exact(inp, 4))
        return tuple(read_typed(inp) for _ in range(n))
    if code == LIST:
        out = []
        while True:
            try:
                out.append(read_typed(inp))
            except _Marker:
                return out
    if code == MAP:
        (n,) = struct.unpack(">i", _read_exact(inp, 4))
        return {read_typed(inp): read_typed(inp) for _ in range(n)}
    if code == MARKER:
        raise _Marker()
    raise TypedBytesError(f"unknown typed-bytes code {code}")


class _Marker(TypedBytesError):
    """LIST terminator encountered (an error anywhere but inside a LIST)."""


def read_pairs(inp: BinaryIO) -> Iterator[tuple[Any, Any]]:
    """(key, value) pairs to the end of the stream. Only an end on a pair
    boundary is clean: a key cut in its frame, or a lone last key, raises,
    so that a child that died in a record cannot pass for complete
    output."""
    while True:
        head = inp.read(1)
        if not head:
            return  # clean boundary: no next frame at all
        try:
            key = _read_body(inp, head[0])
        except EOFError:
            raise TypedBytesError(
                "typed-bytes key truncated mid-frame") from None
        try:
            value = read_typed(inp)
        except EOFError:
            raise TypedBytesError("odd number of typed-bytes values "
                                  "(dangling key at end of stream)") from None
        yield key, value
