"""The child-side pipes runtime for Python executables.

Counterpart of ``tpumr/pipes/child.py``, whole: the Python twin of the C++
runtime (``native/pipes/tpumr_pipes.cc``; the reference's ``Pipes.hh``
Mapper, Reducer, Factory and TaskContext, and the event loop of
``HadoopPipes.cc:475-546``). A pipes executable is any program that calls
:func:`run_task` with a :class:`Factory`; the framework starts it and
speaks ``pipes/protocol.py`` with it over a loopback socket. The frames are
the JAX package's, so a child written against ``tpumr.pipes.child`` runs
under the port's framework and the reverse.

An accelerator child gets the CUDA ordinal of its card as ``argv[1]`` (the
reference's ``cudaSetDevice(argv[1])``); a torch child binds
``torch.device("cuda", int(sys.argv[1]))``. This module imports neither
torch nor numpy, so a CPU child starts in milliseconds and never opens a
CUDA context.
"""

from __future__ import annotations

import socket
from typing import BinaryIO

from tpumr_torch.pipes import protocol as P
from tpumr_torch.pipes.application import ENV_PORT, ENV_SECRET

#: seconds the child waits for the framework's listener
CONNECT_TIMEOUT_S = 30.0


class JobConf:
    def __init__(self, items: dict | None = None) -> None:
        self._items = items or {}

    def get(self, key: str, default: str | None = None) -> str | None:
        return self._items.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._items.get(key)
        return int(v) if v not in (None, "") else default

    def has_key(self, key: str) -> bool:
        return key in self._items


class TaskContext:
    """The reference's TaskContext, MapContext and ReduceContext
    (``Pipes.hh:46-130``)."""

    def __init__(self, up: "_Uplink", conf: JobConf) -> None:
        self._up = up
        self.job_conf = conf
        self.input_key: bytes = b""
        self.input_value: bytes = b""
        self.input_split: bytes = b""
        self.num_reduces = 0
        self._next_counter_id = 0

    def get_job_conf(self) -> JobConf:
        return self.job_conf

    def emit(self, key: bytes | str, value: bytes | str) -> None:
        self._up.output(_b(key), _b(value))

    def partitioned_emit(self, partition: int, key: bytes | str,
                         value: bytes | str) -> None:
        self._up.partitioned_output(partition, _b(key), _b(value))

    def progress(self, value: float) -> None:
        self._up.progress(value)

    def set_status(self, status: str) -> None:
        self._up.status(status)

    def get_counter(self, group: str, name: str) -> int:
        cid = self._next_counter_id
        self._next_counter_id += 1
        self._up.register_counter(cid, group, name)
        return cid

    def increment_counter(self, counter_id: int, amount: int = 1) -> None:
        self._up.increment_counter(counter_id, amount)

    # reduce-side value cursor, filled by the event loop
    def next_value(self) -> bool:
        return self._up.runner.advance_value(self)


def _b(x: bytes | str) -> bytes:
    return x if isinstance(x, bytes) else str(x).encode("utf-8")


class Mapper:
    def map(self, context: TaskContext) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class Reducer:
    def reduce(self, context: TaskContext) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class Factory:
    """The reference's Factory (``Pipes.hh:232-247``)."""

    def create_mapper(self, context: TaskContext) -> Mapper:
        raise NotImplementedError

    def create_reducer(self, context: TaskContext) -> Reducer:
        raise NotImplementedError


class _Uplink:
    def __init__(self, out: BinaryIO, runner: "_TaskRunner") -> None:
        self.out = out
        self.runner = runner

    def output(self, k: bytes, v: bytes) -> None:
        P.write_varint(self.out, P.OUTPUT)
        P.write_bytes(self.out, k)
        P.write_bytes(self.out, v)

    def partitioned_output(self, part: int, k: bytes, v: bytes) -> None:
        P.write_varint(self.out, P.PARTITIONED_OUTPUT)
        P.write_varint(self.out, part)
        P.write_bytes(self.out, k)
        P.write_bytes(self.out, v)

    def status(self, msg: str) -> None:
        P.write_varint(self.out, P.STATUS)
        P.write_str(self.out, msg)
        self.out.flush()

    def progress(self, value: float) -> None:
        P.write_varint(self.out, P.PROGRESS)
        P.write_double(self.out, value)
        self.out.flush()

    def register_counter(self, cid: int, group: str, name: str) -> None:
        P.write_varint(self.out, P.REGISTER_COUNTER)
        P.write_varint(self.out, cid)
        P.write_str(self.out, group)
        P.write_str(self.out, name)

    def increment_counter(self, cid: int, amount: int) -> None:
        P.write_varint(self.out, P.INCREMENT_COUNTER)
        P.write_varint(self.out, cid)
        P.write_varint(self.out, amount)

    def done(self) -> None:
        P.write_varint(self.out, P.DONE)
        self.out.flush()


class _TaskRunner:
    """The child's event loop (``HadoopPipes.cc:475-546``)."""

    def __init__(self, factory: Factory, rfile: BinaryIO,
                 wfile: BinaryIO) -> None:
        self.factory = factory
        self.inp = rfile
        self.up = _Uplink(wfile, self)
        self.ctx: TaskContext | None = None
        self.mapper: Mapper | None = None
        self.reducer: Reducer | None = None
        self._pending_key: bytes | None = None
        self._closed = False

    def authenticate(self, secret: bytes) -> None:
        code = P.read_varint(self.inp)
        if code != P.AUTHENTICATION_REQ:
            raise RuntimeError(f"expected auth request, got {code}")
        digest = P.read_bytes(self.inp)
        challenge = P.read_bytes(self.inp)
        if digest != P.create_digest(secret, b"CLIENT-AUTH"):
            raise RuntimeError("framework failed authentication")
        P.write_varint(self.up.out, P.AUTHENTICATION_RESP)
        P.write_bytes(self.up.out, P.create_digest(secret, challenge))
        self.up.out.flush()

    def run(self) -> int:
        conf = JobConf()
        while True:
            code = P.read_varint(self.inp)
            if code == P.START:
                version = P.read_varint(self.inp)
                if version != P.PROTOCOL_VERSION:
                    raise RuntimeError(f"protocol version {version}")
            elif code == P.SET_JOB_CONF:
                n = P.read_varint(self.inp)
                items = {}
                for _ in range(n):
                    k = P.read_str(self.inp)
                    items[k] = P.read_str(self.inp)
                conf = JobConf(items)
            elif code == P.SET_INPUT_TYPES:
                P.read_str(self.inp)
                P.read_str(self.inp)
            elif code == P.RUN_MAP:
                split = P.read_bytes(self.inp)
                nred = P.read_varint(self.inp)
                piped_input = P.read_varint(self.inp)
                self.ctx = TaskContext(self.up, conf)
                self.ctx.input_split = split
                self.ctx.num_reduces = nred
                self.mapper = self.factory.create_mapper(self.ctx)
                if not piped_input:
                    # own-reader mode (tpumr.pipes.piped.input=false): no
                    # MAP_ITEM frames will come — map() runs once over the
                    # whole split, which the mapper reads itself (same
                    # contract as the C++ child / wordcount-nopipe)
                    self.mapper.map(self.ctx)
            elif code == P.MAP_ITEM:
                if self.mapper is None or self.ctx is None:
                    raise RuntimeError("MAP_ITEM before RUN_MAP")
                self.ctx.input_key = P.read_bytes(self.inp)
                self.ctx.input_value = P.read_bytes(self.inp)
                self.mapper.map(self.ctx)
            elif code == P.RUN_REDUCE:
                P.read_varint(self.inp)  # partition
                P.read_varint(self.inp)  # piped output flag
                self.ctx = TaskContext(self.up, conf)
                self.reducer = self.factory.create_reducer(self.ctx)
            elif code == P.REDUCE_KEY:
                if self.reducer is None or self.ctx is None:
                    raise RuntimeError("REDUCE_KEY before RUN_REDUCE")
                key = P.read_bytes(self.inp)
                self._run_reduce_groups(key)
                if self._closed:
                    break
            elif code == P.CLOSE:
                break
            elif code == P.ABORT:
                return 1
            else:
                raise RuntimeError(f"unknown downward code {code}")
        if self.mapper is not None:
            self.mapper.close()
        if self.reducer is not None:
            self.reducer.close()
        self.up.done()
        return 0

    def _run_reduce_groups(self, first_key: bytes) -> None:
        """Drive reduce(ctx) once per key; ctx.next_value() pulls
        REDUCE_VALUE frames off the wire (the C++ context's nextValue).
        Called after RUN_REDUCE made the context and reducer."""
        self._pending_key = first_key
        while self._pending_key is not None and not self._closed:
            self.ctx.input_key = self._pending_key
            self._pending_key = None
            self.reducer.reduce(self.ctx)
            # drain any values the reducer didn't consume
            while self.advance_value(self.ctx):
                pass

    def advance_value(self, ctx: TaskContext) -> bool:
        if self._pending_key is not None or self._closed:
            return False
        code = P.read_varint(self.inp)
        if code == P.REDUCE_VALUE:
            ctx.input_value = P.read_bytes(self.inp)
            return True
        if code == P.REDUCE_KEY:
            self._pending_key = P.read_bytes(self.inp)
            return False
        if code == P.CLOSE:
            self._closed = True
            return False
        raise RuntimeError(f"unexpected code {code} inside reduce")


def run_task(factory: Factory) -> int:
    """The child's entry point (the reference's ``HadoopPipes::runTask``):
    connect back, authenticate, run the event loop; the exit code."""
    import os
    port = int(os.environ[ENV_PORT])
    secret = bytes.fromhex(os.environ[ENV_SECRET])
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.settimeout(CONNECT_TIMEOUT_S)
    sock.connect(("127.0.0.1", port))
    sock.settimeout(None)
    rfile = sock.makefile("rb")
    wfile = sock.makefile("wb")
    try:
        runner = _TaskRunner(factory, rfile, wfile)
        runner.authenticate(secret)
        rc = runner.run()
        wfile.flush()
        return rc
    finally:
        rfile.close()
        wfile.close()
        sock.close()

