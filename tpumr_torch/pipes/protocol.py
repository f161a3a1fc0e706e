"""The framed binary protocol between the framework and a pipes child.

Counterpart of ``tpumr/pipes/protocol.py``, whole, and byte for byte the
same frames, so a child written against either package's runtime talks to
either package's :class:`~tpumr_torch.pipes.application.Application`. The
reference is ``BinaryProtocol.java`` (downward codes START = 0 to ABORT = 9
and AUTHENTICATION_REQ = 10; upward OUTPUT = 50 to DONE = 54,
REGISTER_COUNTER = 55, INCREMENT_COUNTER = 56) and its C++ twin
``native/pipes/tpumr_pipes.cc``. Every message is ``vint(code)`` followed by
the fields named beside its code: vints are unsigned LEB128 (the port's
``io/writable``), strings and byte strings a vint length and the bytes,
doubles IEEE-754 big-endian. Authentication is a mutual HMAC-SHA1
challenge over a secret shared per child.

Imports nothing but the standard library and ``io/writable`` (no numpy at
import): the child runtime, ``pipes/child.py``, frames through it.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
from typing import BinaryIO

from tpumr_torch.io.writable import read_vint, write_vint

PROTOCOL_VERSION = 0

# downward (framework -> child), BinaryProtocol.java:67-78
START = 0                # version:int
SET_JOB_CONF = 1         # n:int, then n*(key:str, value:str)
SET_INPUT_TYPES = 2      # key_type:str, value_type:str
RUN_MAP = 3              # split:bytes, num_reduces:int, piped_input:int
MAP_ITEM = 4             # key:bytes, value:bytes
RUN_REDUCE = 5           # partition:int, piped_output:int
REDUCE_KEY = 6           # key:bytes
REDUCE_VALUE = 7         # value:bytes
CLOSE = 8                # -
ABORT = 9                # -
AUTHENTICATION_REQ = 10  # digest:bytes, challenge:bytes

# upward (child -> framework), BinaryProtocol.java:79-84
OUTPUT = 50               # key:bytes, value:bytes
PARTITIONED_OUTPUT = 51   # partition:int, key:bytes, value:bytes
STATUS = 52               # message:str
PROGRESS = 53             # value:double
DONE = 54                 # -
REGISTER_COUNTER = 55     # id:int, group:str, name:str
INCREMENT_COUNTER = 56    # id:int, amount:int
AUTHENTICATION_RESP = 57  # digest:bytes


#: the io layer's unsigned LEB128, the one vint of both packages
write_varint = write_vint
read_varint = read_vint


def write_bytes(out: BinaryIO, data: bytes) -> None:
    write_varint(out, len(data))
    out.write(data)


def read_bytes(inp: BinaryIO) -> bytes:
    n = read_varint(inp)
    data = inp.read(n)
    if len(data) != n:
        raise EOFError("pipes stream closed mid-string")
    return data


def write_str(out: BinaryIO, s: str) -> None:
    write_bytes(out, s.encode("utf-8"))


def read_str(inp: BinaryIO) -> str:
    return read_bytes(inp).decode("utf-8")


def write_double(out: BinaryIO, x: float) -> None:
    out.write(struct.pack(">d", x))


def read_double(inp: BinaryIO) -> float:
    data = inp.read(8)
    if len(data) != 8:
        raise EOFError("pipes stream closed mid-double")
    return struct.unpack(">d", data)[0]


def create_digest(secret: bytes, message: bytes) -> bytes:
    """HMAC-SHA1 hex digest (≈ SecureShuffleUtils.hashFromString used by the
    pipes auth handshake)."""
    return hmac.new(secret, message, hashlib.sha1).hexdigest().encode("ascii")


class DownwardProtocol:
    """Framework side: sends downward messages, used by Application."""

    def __init__(self, out: BinaryIO) -> None:
        self.out = out

    def _code(self, code: int) -> None:
        write_varint(self.out, code)

    def authenticate(self, digest: bytes, challenge: bytes) -> None:
        self._code(AUTHENTICATION_REQ)
        write_bytes(self.out, digest)
        write_bytes(self.out, challenge)
        self.out.flush()

    def start(self) -> None:
        self._code(START)
        write_varint(self.out, PROTOCOL_VERSION)

    def set_job_conf(self, conf_items: dict) -> None:
        self._code(SET_JOB_CONF)
        write_varint(self.out, len(conf_items))
        for k, v in conf_items.items():
            write_str(self.out, str(k))
            write_str(self.out, "" if v is None else str(v))

    def set_input_types(self, key_type: str, value_type: str) -> None:
        self._code(SET_INPUT_TYPES)
        write_str(self.out, key_type)
        write_str(self.out, value_type)

    def run_map(self, split: bytes, num_reduces: int,
                piped_input: bool) -> None:
        self._code(RUN_MAP)
        write_bytes(self.out, split)
        write_varint(self.out, num_reduces)
        write_varint(self.out, int(piped_input))

    def map_item(self, key: bytes, value: bytes) -> None:
        self._code(MAP_ITEM)
        write_bytes(self.out, key)
        write_bytes(self.out, value)

    def run_reduce(self, partition: int, piped_output: bool) -> None:
        self._code(RUN_REDUCE)
        write_varint(self.out, partition)
        write_varint(self.out, int(piped_output))

    def reduce_key(self, key: bytes) -> None:
        self._code(REDUCE_KEY)
        write_bytes(self.out, key)

    def reduce_value(self, value: bytes) -> None:
        self._code(REDUCE_VALUE)
        write_bytes(self.out, value)

    def close(self) -> None:
        self._code(CLOSE)
        self.out.flush()

    def abort(self) -> None:
        self._code(ABORT)
        self.out.flush()

    def flush(self) -> None:
        self.out.flush()
