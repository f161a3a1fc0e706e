"""Block compression codecs, by name.

Counterpart of ``tpumr/io/compress.py``, trimmed to the codecs that the
standard library gives (``:81-146``): ``none``, ``zlib`` (also ``default``),
``gzip``, ``bzip2`` and ``lzma``, under the JAX package's names, so a
SequenceFile header written by either package names a codec the other
reads. Each codec also gives a streaming ``decompressor()`` (``:28-79``):
compressed chunks in, raw bytes out as they become available, which the
merge of compressed spill segments reads through
(``ifile.iter_chunked_segment``). The native ``tlz`` codec
(``native/tlz/``, ``:148-312``) is not ported: asking for it raises, and so
does reading a file written with it.

The shuffle's wire codec (``:344-377``): :func:`wire_codec_or_none` turns
``tpumr.shuffle.wire.codec`` into a codec this process has, else ``none``
(so the JAX package's default, ``tlz``, sends chunks uncompressed here),
and :func:`wire_compress` compresses a served chunk of an uncompressed
spill only where that makes it smaller. The client undoes it by the
``wire`` field of the response (``shuffle_copier.RemoteChunkSource``).
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import zlib


class Decompressor:
    """``feed(data)`` returns the raw bytes available so far; ``flush()``
    the rest."""

    def feed(self, data: bytes) -> bytes:
        return data

    def flush(self) -> bytes:
        return b""


class _ObjDecompressor(Decompressor):
    """Over a stdlib ``decompressobj``-style object."""

    def __init__(self, obj) -> None:
        self._obj = obj

    def feed(self, data: bytes) -> bytes:
        return self._obj.decompress(data)

    def flush(self) -> bytes:
        fl = getattr(self._obj, "flush", None)
        return fl() if fl is not None else b""


class CompressionCodec:
    name = "none"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data

    def decompressor(self) -> Decompressor:
        """A streaming decompressor (the identity for ``none``)."""
        return Decompressor()


class ZlibCodec(CompressionCodec):
    name = "zlib"

    def __init__(self, level: int = 6) -> None:
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)

    def decompressor(self) -> Decompressor:
        return _ObjDecompressor(zlib.decompressobj())


class GzipCodec(CompressionCodec):
    name = "gzip"

    def compress(self, data: bytes) -> bytes:
        return gzip.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return gzip.decompress(data)

    def decompressor(self) -> Decompressor:
        return _ObjDecompressor(zlib.decompressobj(16 + zlib.MAX_WBITS))


class Bzip2Codec(CompressionCodec):
    name = "bzip2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return bz2.decompress(data)

    def decompressor(self) -> Decompressor:
        return _ObjDecompressor(bz2.BZ2Decompressor())


class LzmaCodec(CompressionCodec):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return lzma.decompress(data)

    def decompressor(self) -> Decompressor:
        return _ObjDecompressor(lzma.LZMADecompressor())


_REGISTRY: dict[str, type[CompressionCodec]] = {
    "none": CompressionCodec,
    "zlib": ZlibCodec,
    "default": ZlibCodec,
    "gzip": GzipCodec,
    "bzip2": Bzip2Codec,
    "lzma": LzmaCodec,
}

#: codecs of the JAX package that the port does not have
NOT_PORTED = {"tlz": "the native codec (native/tlz/) is not ported"}


def get_codec(name: "str | None") -> CompressionCodec:
    if not name:
        return CompressionCodec()
    cls = _REGISTRY.get(name.lower())
    if cls is None:
        why = NOT_PORTED.get(name.lower())
        if why:
            raise ValueError(f"codec {name!r}: {why}; the port has "
                             f"{sorted(_REGISTRY)}")
        raise ValueError(f"unknown codec {name!r}; have {sorted(_REGISTRY)}")
    return cls()


def wire_codec_or_none(name: "str | None") -> str:
    """The configured wire codec where this process has it, else
    ``none``: the wire codec is a transport choice, never a format, so a
    codec the port lacks sends chunks as they are."""
    if not name or name == "none":
        return "none"
    return name.lower() if name.lower() in _REGISTRY else "none"


#: chunks shorter than this go uncompressed: the codec's frame eats the gain
WIRE_MIN_BYTES = 1024


def wire_compress(out: dict, wire: str) -> None:
    """Compress one served chunk's ``data`` in place for the wire, and
    name the codec in ``out["wire"]``, where the client offered a codec,
    the spill itself is uncompressed, and the result is shorter; else
    leave ``out`` as it is."""
    if (not wire or wire == "none" or out.get("codec", "none") != "none"
            or len(out["data"]) < WIRE_MIN_BYTES):
        return
    try:
        comp = get_codec(wire).compress(bytes(out["data"]))
    except Exception:  # noqa: BLE001 — the wire codec is best-effort
        return
    if len(comp) < len(out["data"]):
        out["wire"] = wire
        out["data"] = comp
