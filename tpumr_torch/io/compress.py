"""Block compression codecs, by name.

Counterpart of ``tpumr/io/compress.py``, trimmed to the codecs that the
standard library gives (``:81-146``): ``none``, ``zlib`` (also ``default``),
``gzip``, ``bzip2`` and ``lzma``, under the JAX package's names, so a
SequenceFile header written by either package names a codec the other
reads. The native ``tlz`` codec (``native/tlz/``, ``:148-312``) is not
ported: asking for it raises, and so does reading a file written with it.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import zlib


class CompressionCodec:
    name = "none"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


class ZlibCodec(CompressionCodec):
    name = "zlib"

    def __init__(self, level: int = 6) -> None:
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


class GzipCodec(CompressionCodec):
    name = "gzip"

    def compress(self, data: bytes) -> bytes:
        return gzip.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return gzip.decompress(data)


class Bzip2Codec(CompressionCodec):
    name = "bzip2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return bz2.decompress(data)


class LzmaCodec(CompressionCodec):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return lzma.decompress(data)


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
