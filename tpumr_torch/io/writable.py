"""Binary record serialization for map outputs and spill files.

Counterpart of ``tpumr/io/writable.py`` (``serialize`` at :86,
``deserialize`` at :215, the vint stream helpers at :25-56). The bytes are
the JAX package's, tag for tag, so the two packages' map outputs,
partitions, SequenceFiles and byte counters agree. numpy is imported only
where a value is a numpy scalar or array: the pipes child runtime
(``pipes/child.py``) frames its messages with the vints here and loads no
numpy.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

_T_NULL = 0
_T_BYTES = 1
_T_TEXT = 2
_T_INT = 3      # zigzag varint
_T_FLOAT = 4    # float64 BE
_T_BOOL_T = 5
_T_BOOL_F = 6
_T_LIST = 7
_T_NDARRAY = 8  # dtype-str, shape, raw bytes
_T_DICT = 9

#: the tag byte of a ``bytes`` value: the fixed-width record frames
_TAG_BYTES = bytes((_T_BYTES,))
_TAG_TEXT = bytes((_T_TEXT,))
_TAG_INT = bytes((_T_INT,))


def vint_into(buf: bytearray, value: int) -> None:
    """Unsigned LEB128."""
    if value < 0:
        raise ValueError("vint takes unsigned values; use zigzag first")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def vint_at(d: bytes, pos: int) -> "tuple[int, int]":
    shift = result = 0
    while True:
        b = d[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def vint_bytes(value: int) -> bytes:
    if 0 <= value < 0x80:
        return bytes((value,))
    buf = bytearray()
    vint_into(buf, value)
    return bytes(buf)


def write_vint(out: BinaryIO, value: int) -> None:
    out.write(vint_bytes(value))


def read_vint(inp: BinaryIO) -> int:
    shift = result = 0
    while True:
        raw = inp.read(1)
        if not raw:
            raise EOFError("EOF inside vint")
        result |= (raw[0] & 0x7F) << shift
        if not raw[0] & 0x80:
            return result
        shift += 7


def _zigzag(v: int) -> int:
    return (v << 1) if v >= 0 else ((-v) << 1) - 1


def _unzigzag(v: int) -> int:
    return (v >> 1) if not v & 1 else -((v + 1) >> 1)


def serialize(obj: Any) -> bytes:
    """The typed binary form of ``obj``. ``bytes``, ``str`` and ``int``
    take a direct path (``type() is``, so ``bool`` and numpy scalars take
    the general one): a map output pays two of these a record, three
    under the hash partitioner."""
    t = type(obj)
    if t is bytes:
        return _TAG_BYTES + vint_bytes(len(obj)) + obj
    if t is str:
        b = obj.encode("utf-8")
        return _TAG_TEXT + vint_bytes(len(b)) + b
    if t is int:
        return _TAG_INT + vint_bytes(_zigzag(obj))
    buf = bytearray()
    _enc(buf, obj)
    return bytes(buf)


def _enc(buf: bytearray, obj: Any) -> None:
    if obj is None:
        buf.append(_T_NULL)
    elif isinstance(obj, bool):
        buf.append(_T_BOOL_T if obj else _T_BOOL_F)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        buf.append(_T_BYTES)
        vint_into(buf, len(b))
        buf += b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        buf.append(_T_TEXT)
        vint_into(buf, len(b))
        buf += b
    elif isinstance(obj, int):
        buf.append(_T_INT)
        vint_into(buf, _zigzag(obj))
    elif isinstance(obj, float):
        buf.append(_T_FLOAT)
        buf += struct.pack(">d", obj)
    elif isinstance(obj, (list, tuple)):
        buf.append(_T_LIST)
        vint_into(buf, len(obj))
        for item in obj:
            _enc(buf, item)
    elif isinstance(obj, dict):
        buf.append(_T_DICT)
        vint_into(buf, len(obj))
        for k, v in obj.items():
            _enc(buf, k)
            _enc(buf, v)
    else:
        _enc_numpy(buf, obj)


def _enc_numpy(buf: bytearray, obj: Any) -> None:
    """A numpy scalar or array (none is an ``int``, list, tuple or dict, so
    the order of the checks gives the JAX package's tags)."""
    import numpy as np
    if isinstance(obj, np.integer):
        buf.append(_T_INT)
        vint_into(buf, _zigzag(int(obj)))
    elif isinstance(obj, np.floating):
        buf.append(_T_FLOAT)
        buf += struct.pack(">d", float(obj))
    elif isinstance(obj, np.ndarray):
        buf.append(_T_NDARRAY)
        dt = obj.dtype.str.encode()
        vint_into(buf, len(dt))
        buf += dt
        vint_into(buf, obj.ndim)
        for dim in obj.shape:
            vint_into(buf, dim)
        raw = np.ascontiguousarray(obj).tobytes()
        vint_into(buf, len(raw))
        buf += raw
    else:
        raise TypeError(f"unserializable type {type(obj)!r}")


def deserialize(data: bytes) -> Any:
    """The value :func:`serialize` encoded, with a direct path for a short
    ``bytes`` or ``str`` (a sort key is decoded on every comparison)."""
    if len(data) > 1 and data[1] < 0x80 and len(data) == data[1] + 2:
        tag = data[0]
        if tag == _T_BYTES:
            return bytes(data[2:])
        if tag == _T_TEXT:
            return bytes(data[2:]).decode("utf-8")
    try:
        return _read_at(data, 0)[0]
    except IndexError:
        raise EOFError("truncated value buffer") from None


def _read_at(d: bytes, pos: int) -> "tuple[Any, int]":
    tag = d[pos]
    pos += 1
    if tag == _T_NULL:
        return None, pos
    if tag == _T_BOOL_T:
        return True, pos
    if tag == _T_BOOL_F:
        return False, pos
    if tag in (_T_BYTES, _T_TEXT):
        n, pos = vint_at(d, pos)
        raw = bytes(d[pos:pos + n])
        return (raw if tag == _T_BYTES else raw.decode("utf-8")), pos + n
    if tag == _T_INT:
        v, pos = vint_at(d, pos)
        return _unzigzag(v), pos
    if tag == _T_FLOAT:
        return struct.unpack_from(">d", d, pos)[0], pos + 8
    if tag == _T_NDARRAY:
        import numpy as np
        n, pos = vint_at(d, pos)
        dt = np.dtype(bytes(d[pos:pos + n]).decode())
        pos += n
        ndim, pos = vint_at(d, pos)
        shape = []
        for _ in range(ndim):
            dim, pos = vint_at(d, pos)
            shape.append(dim)
        nraw, pos = vint_at(d, pos)
        arr = np.frombuffer(d, dtype=dt, count=nraw // dt.itemsize,
                            offset=pos).reshape(tuple(shape)).copy()
        return arr, pos + nraw
    if tag == _T_LIST:
        n, pos = vint_at(d, pos)
        out = []
        for _ in range(n):
            item, pos = _read_at(d, pos)
            out.append(item)
        return out, pos
    if tag == _T_DICT:
        n, pos = vint_at(d, pos)
        res = {}
        for _ in range(n):
            k, pos = _read_at(d, pos)
            v, pos = _read_at(d, pos)
            res[k] = v
        return res, pos
    raise ValueError(f"bad type tag {tag}")
