"""Host-level RPC: the control plane of the port's cluster (heartbeats,
submissions, status polls, commit grants, shuffle fetches).

Counterpart of ``tpumr/ipc/rpc.py``, trimmed to one transport:

- frames are a big-endian u32 length and a value in the port's own codec
  (``io/writable.serialize``/``deserialize``, ``:113-175`` there), so None,
  bool, int, float, str, bytes, ndarray, list and dict cross the wire;
- :class:`RpcServer` serves the public methods of a handler object, and of
  extra named protocols (``add_protocol``, ``lookup``), on one thread per
  connection (``:555-998``); an exception in a method comes back to the
  caller as :class:`RpcError` carrying its type name and message;
- :class:`RpcClient` holds one socket, serialises concurrent calls on a
  lock, and retries a call that failed in transport a bounded number of
  times (``:999-1295``); :func:`get_proxy` wraps it (``:1459``);
- a server binds port 0 unless told otherwise, so servers started side by
  side (parallel test workers, a mini cluster's daemons) never collide.

Left out (``ROADMAP.md``): the selector reactor and its handler pool, HMAC
authentication, the (client id, request id) replay cache, client pools,
pipelined calls (``call_begin``/``call_finish``) and per-method metrics.
Without the replay cache a call retried after a lost response may run
twice on the server; the port's non-idempotent caller, the node runner's
heartbeat, carries its own response id for that (``JobMaster.heartbeat``).
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
import traceback
from typing import Any

from tpumr_torch.io.writable import deserialize, serialize

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30
#: seconds ``RpcServer.stop`` waits for each of its threads to end
JOIN_TIMEOUT_S = 5.0
#: ``RpcClient``'s sleep before its second retry, doubled for each later
#: one up to ``BACKOFF_MAX_S``
BACKOFF_S = 0.2
BACKOFF_MAX_S = 5.0


class RpcError(RuntimeError):
    """An exception raised by the remote method. ``remote_type`` is its
    class name and ``remote_message`` its message."""

    def __init__(self, remote_type: str, remote_message: str,
                 remote_traceback: str = "") -> None:
        super().__init__(f"{remote_type}: {remote_message}"
                         + (f"\n[remote] {remote_traceback}"
                            if remote_traceback else ""))
        self.remote_type = remote_type
        self.remote_message = remote_message


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes received straight into one buffer of that size: a
    ``recv`` of a large size allocates that size for each call however
    little arrives, which makes a large frame slow (PERF.md §6 has the
    rates)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _send_payload(sock: socket.socket, payload: bytes) -> None:
    """The length and the payload; a large payload is not copied to join
    them."""
    if len(payload) < (1 << 16):
        sock.sendall(_LEN.pack(len(payload)) + payload)
    else:
        sock.sendall(_LEN.pack(len(payload)))
        sock.sendall(payload)


def _send_frame(sock: socket.socket, obj: Any) -> None:
    _send_payload(sock, serialize(obj))


def _recv_frame(sock: socket.socket) -> Any:
    (length,) = _LEN.unpack(_read_exact(sock, 4))
    if length > MAX_FRAME:
        raise ConnectionError(f"frame too large: {length}")
    # a view: the values are copied out of the frame once
    return deserialize(memoryview(_read_exact(sock, length)))


class _Handler(socketserver.BaseRequestHandler):
    """One connection: read a request frame, answer it, until the peer
    closes or the server stops."""

    def setup(self) -> None:
        self.server.rpc._track(self.request)  # type: ignore[attr-defined]

    def finish(self) -> None:
        self.server.rpc._untrack(self.request)  # type: ignore[attr-defined]

    def handle(self) -> None:
        rpc: RpcServer = self.server.rpc  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                resp = rpc.serve_request(_recv_frame(sock))
                try:
                    payload = serialize(resp)
                except TypeError as e:   # a result the codec cannot carry
                    payload = serialize({"id": resp.get("id"),
                                         "error": ["TypeError", str(e)]})
                _send_payload(sock, payload)
        except (ConnectionError, OSError, EOFError):
            return


class _ThreadingServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    block_on_close = False


class RpcServer:
    """Serves the public methods of ``handler`` (and of protocols added
    under a name, called as ``"<name>.<method>"``) over TCP on
    ``host:port``; port 0 takes a free one (see :attr:`address`)."""

    def __init__(self, handler: Any, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self._handlers: dict[str, Any] = {"": handler}
        self._server = _ThreadingServer((host, port), _Handler)
        self._server.rpc = self  # type: ignore[attr-defined]
        self._thread: "threading.Thread | None" = None
        self._conns: dict[socket.socket, threading.Thread] = {}
        self._conns_lock = threading.Lock()

    def _track(self, sock: socket.socket) -> None:
        with self._conns_lock:
            self._conns[sock] = threading.current_thread()

    def _untrack(self, sock: socket.socket) -> None:
        with self._conns_lock:
            self._conns.pop(sock, None)

    def add_protocol(self, name: str, handler: Any) -> None:
        self._handlers[name] = handler

    def lookup(self, method: str):
        ns, _, name = method.rpartition(".")
        handler = self._handlers.get(ns)
        if handler is None or name.startswith("_"):
            raise AttributeError(f"no such method {method!r}")
        fn = getattr(handler, name, None)
        if fn is None or not callable(fn):
            raise AttributeError(f"no such method {method!r}")
        return fn

    def serve_request(self, req: dict) -> dict:
        """One request frame to its response: the method's result, or the
        name, message and traceback of what it raised."""
        resp: dict[str, Any] = {"id": req.get("id")}
        try:
            resp["result"] = self.lookup(req["method"])(
                *req.get("params", []))
        except Exception as e:  # noqa: BLE001 — the remote surface
            resp["error"] = [type(e).__name__, str(e),
                             traceback.format_exc(limit=8)]
        return resp

    @property
    def address(self) -> tuple[str, int]:
        host, port = self._server.server_address[:2]
        return str(host), int(port)

    @property
    def port(self) -> int:
        return self.address[1]

    def start(self) -> "RpcServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            name=f"rpc-server-{self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting, close the listening socket and every open
        connection, and join the server's threads (each for at most
        ``JOIN_TIMEOUT_S``)."""
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = dict(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        me = threading.current_thread()
        for t in [self._thread, *conns.values()]:
            if t is not None and t is not me:
                t.join(JOIN_TIMEOUT_S)


class RpcClient:
    """One cached connection to a server; calls from several threads are
    serialised on a lock. A call that fails in transport (refused, reset,
    timed out) is retried up to ``retries`` times on a new connection, the
    first retry at once and later ones after a doubling backoff; an error
    raised by the remote method (:class:`RpcError`) is never retried."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 retries: int = 1) -> None:
        self.host, self.port = host, int(port)
        self.timeout = timeout
        self.retries = max(0, int(retries))
        self._lock = threading.Lock()
        self._sock: "socket.socket | None" = None
        self._id = 0

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def call(self, method: str, *params: Any) -> Any:
        with self._lock:
            self._id += 1
            req = {"id": self._id, "method": method, "params": list(params)}
            attempt = 0
            while True:
                try:
                    sock = self._connect()
                    _send_frame(sock, req)
                    resp = _recv_frame(sock)
                    break
                except (ConnectionError, OSError, EOFError):
                    self._close_locked()
                    attempt += 1
                    if attempt > self.retries:
                        raise
                    if attempt > 1:
                        time.sleep(min(BACKOFF_MAX_S,
                                       BACKOFF_S * 2 ** (attempt - 2)))
        if "error" in resp:
            raise RpcError(*resp["error"])
        return resp.get("result")

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()


class _Proxy:
    def __init__(self, client: RpcClient, namespace: str = "") -> None:
        self._client = client
        self._ns = namespace

    def __getattr__(self, name: str):
        method = f"{self._ns}.{name}" if self._ns else name
        return lambda *params: self._client.call(method, *params)


def get_proxy(host: str, port: int, protocol_version: "int | None" = None,
              namespace: str = "", timeout: float = 30.0) -> Any:
    """A method proxy over a new :class:`RpcClient`; with
    ``protocol_version``, checks the server's ``get_protocol_version``
    first."""
    client = RpcClient(host, port, timeout=timeout)
    proxy = _Proxy(client, namespace)
    if protocol_version is not None:
        remote = proxy.get_protocol_version()
        if remote != protocol_version:
            client.close()
            raise RpcError("RpcError", f"protocol version mismatch: client "
                           f"{protocol_version}, server {remote}")
    return proxy
