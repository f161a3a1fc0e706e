"""One pipes child process and the framework's end of its connection.

Counterpart of ``tpumr/pipes/application.py`` (the reference's
``Application.java``):

- :func:`select_executable` takes the job's ordered cache list
  (``mapred/filecache.py``) at index ``1 if run_on_tpu else 0``: the
  second binary for an accelerator-slot task, the first otherwise;
- an accelerator task passes the card's CUDA ordinal as ``argv[1]``, the
  reference's ``cudaSetDevice(argv[1])`` (:func:`cuda_ordinal`);
- the framework listens on a loopback port, the child connects back to the
  port in its environment (``TPUMR_PIPES_COMMAND_PORT``), and each side
  proves it holds the secret in ``TPUMR_PIPES_SHARED_SECRET`` by an
  HMAC-SHA1 of the other's challenge;
- a thread pumps the uplink into the task's collector and reporter, the
  child's counters registered by id and incremented by name;
- with ``mapred.task.limit.maxrss.mb`` set, the child is registered with
  the node's memory manager (``node_health.GLOBAL_MEMORY_MANAGER``), which
  kills it above the limit, and unregistered at :meth:`Application.cleanup`.

The child is started with ``subprocess.Popen`` (fork and exec), never a
``multiprocessing`` fork of a process whose threads may hold a CUDA
context. Every wait is bounded: the connect by ``connect_timeout``, the
task by ``mapred.task.timeout``, the exit by :data:`EXIT_TIMEOUT_S`; a child
that is killed is also reaped.
"""

from __future__ import annotations

import os
import secrets
import socket
import subprocess
import threading
from typing import Any

from tpumr_torch.pipes import protocol as P

#: the child's environment: the port to connect back to and the shared
#: secret (the reference's ``hadoop.pipes.command.port`` and its job token)
ENV_PORT = "TPUMR_PIPES_COMMAND_PORT"
ENV_SECRET = "TPUMR_PIPES_SHARED_SECRET"
#: seconds a child that sent DONE, or was killed, has to exit
EXIT_TIMEOUT_S = 30.0


class PipesChildError(RuntimeError):
    pass


class Application:
    """One pipes child process and its protocol connection."""

    def __init__(self, conf: Any, executable: str, output: Any,
                 reporter: Any, run_on_tpu: bool = False,
                 device_ordinal: int = -1,
                 connect_timeout: float = 30.0) -> None:
        self.conf = conf
        self.output = output
        self.reporter = reporter
        self.done = threading.Event()
        self.child_error: "str | None" = None
        self._counters: "dict[int, tuple[str, str]]" = {}
        self._mem_key: "str | None" = None
        self._pump: "threading.Thread | None" = None

        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        listener.settimeout(connect_timeout)
        self._secret = secrets.token_bytes(16)
        env = dict(os.environ)
        env[ENV_PORT] = str(listener.getsockname()[1])
        env[ENV_SECRET] = self._secret.hex()
        cmd = [executable]
        if run_on_tpu:
            cmd.append(str(device_ordinal))   # the child's cudaSetDevice
        try:
            self.process = subprocess.Popen(cmd, env=env,
                                            stdin=subprocess.DEVNULL)
        except OSError as e:
            listener.close()
            raise PipesChildError(f"cannot exec {executable}: {e}") from e
        try:
            self.sock, _ = listener.accept()
        except OSError:   # socket.timeout is an OSError
            self._kill_and_reap()
            raise PipesChildError(
                f"pipes child {executable} never connected back "
                f"(rc={self.process.returncode})") from None
        finally:
            listener.close()
        self.sock.settimeout(None)
        self._rfile = self.sock.makefile("rb")
        self._wfile = self.sock.makefile("wb")
        self.downlink = P.DownwardProtocol(self._wfile)

        limit_mb = int(conf.get("mapred.task.limit.maxrss.mb", 0) or 0)
        if limit_mb > 0:
            from tpumr_torch.mapred.node_health import GLOBAL_MEMORY_MANAGER
            self._mem_key = (str(conf.get("tpumr.task.attempt.id", ""))
                             or f"pid-{self.process.pid}")
            GLOBAL_MEMORY_MANAGER.register(
                self._mem_key, self.process.pid, limit_mb << 20,
                lambda _aid: self.process.kill())
        try:
            self._authenticate()
        except Exception:
            self.cleanup(kill=True)
            raise
        self._pump = threading.Thread(target=self._uplink_loop,
                                      name="pipes-uplink", daemon=True)
        self._pump.start()

    # ------------------------------------------------------------ handshake

    def _authenticate(self) -> None:
        """We digest a fixed message with the secret; the child digests our
        random challenge."""
        challenge = secrets.token_hex(10).encode("ascii")
        self.downlink.authenticate(P.create_digest(self._secret,
                                                   b"CLIENT-AUTH"), challenge)
        code = P.read_varint(self._rfile)
        if code != P.AUTHENTICATION_RESP:
            raise PipesChildError(f"expected auth response, got code {code}")
        if P.read_bytes(self._rfile) != P.create_digest(self._secret,
                                                        challenge):
            raise PipesChildError("pipes child failed authentication")

    # ------------------------------------------------------------ uplink

    def _uplink_loop(self) -> None:
        """The reference's OutputHandler: every upward frame until DONE. An
        error ends the loop with ``child_error`` set, never silently."""
        r = self._rfile
        try:
            while True:
                code = P.read_varint(r)
                if code == P.OUTPUT:
                    k = P.read_bytes(r)
                    self.output.collect(k, P.read_bytes(r))
                elif code == P.PARTITIONED_OUTPUT:
                    part = P.read_varint(r)
                    k = P.read_bytes(r)
                    self.output.partitioned_collect(part, k, P.read_bytes(r))
                elif code == P.STATUS:
                    self.reporter.set_status(P.read_str(r))
                elif code == P.PROGRESS:
                    self.reporter.progress(P.read_double(r))
                elif code == P.REGISTER_COUNTER:
                    cid = P.read_varint(r)
                    group = P.read_str(r)
                    self._counters[cid] = (group, P.read_str(r))
                elif code == P.INCREMENT_COUNTER:
                    cid = P.read_varint(r)
                    amount = P.read_varint(r)
                    group, name = self._counters.get(
                        cid, ("Pipes", f"counter-{cid}"))
                    self.reporter.incr_counter(group, name, amount)
                elif code == P.DONE:
                    self.done.set()
                    return
                else:
                    raise PipesChildError(f"unknown upward code {code}")
        except (EOFError, OSError) as e:
            if not self.done.is_set():
                self.child_error = f"pipes child died mid-task: {e}"
                self.done.set()
        except Exception as e:  # noqa: BLE001 — a protocol or collector
            # error: the waiter must learn it, not wait out the timeout
            if not self.done.is_set():
                self.child_error = (f"pipes uplink failed: "
                                    f"{type(e).__name__}: {e}")
                self.done.set()

    # ------------------------------------------------------------ lifecycle

    def wait_for_finish(self, timeout: "float | None" = None) -> None:
        """Wait for DONE (at most ``timeout`` s, else ``mapred.task.timeout``
        when above 0) and a clean exit; raise :class:`PipesChildError`
        otherwise."""
        if timeout is None:
            ms = int(self.conf.get("mapred.task.timeout", 600_000) or 0)
            timeout = ms / 1000.0 if ms > 0 else None
        if not self.done.wait(timeout):
            self.abort()
            raise PipesChildError("pipes child timed out")
        if self.child_error:
            self.cleanup(kill=True)
            raise PipesChildError(self.child_error)
        try:
            rc = self.process.wait(timeout=EXIT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.cleanup(kill=True)
            raise PipesChildError("pipes child sent DONE and never exited") \
                from None
        if rc != 0:
            raise PipesChildError(f"pipes child exited rc={rc}")

    def abort(self) -> None:
        try:
            self.downlink.abort()
        except OSError:
            pass
        self.cleanup(kill=True)

    def _kill_and_reap(self) -> None:
        if self.process.poll() is None:
            self.process.kill()
        try:
            self.process.wait(timeout=EXIT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass

    def cleanup(self, kill: bool = False) -> None:
        """Unregister from the memory manager, kill and reap the child if
        asked (or if it still runs after DONE's wait), close the socket and
        join the uplink thread. Idempotent."""
        if self._mem_key is not None:
            from tpumr_torch.mapred.node_health import GLOBAL_MEMORY_MANAGER
            GLOBAL_MEMORY_MANAGER.unregister(self._mem_key)
            self._mem_key = None
        if kill:
            self._kill_and_reap()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)   # wakes a blocked pump
        except OSError:
            pass
        for f in (self._rfile, self._wfile, self.sock):
            try:
                f.close()
            except OSError:
                pass
        pump = self._pump
        if pump is not None and pump is not threading.current_thread():
            pump.join(EXIT_TIMEOUT_S)


def select_executable(conf: Any, cache_root: str, run_on_tpu: bool) -> str:
    """The dual-executable pick: cache list index 1 for an accelerator
    task, 0 otherwise; index 0 where the job shipped one binary."""
    from tpumr_torch.mapred import filecache
    files = filecache.get_local_cache_files(
        conf, cache_root, job_id=str(conf.get("tpumr.job.id", "") or ""))
    if not files:
        raise PipesChildError("pipes job has no cached executables")
    return files[1 if run_on_tpu and len(files) > 1 else 0]


def cuda_ordinal(conf: Any, device_id: int) -> int:
    """The ordinal an accelerator task's child binds: the card the slot's
    device id names on ``cuda`` (``device.select_device``), the device id
    itself where the node runs on the CPU."""
    from tpumr_torch.device import DEVICE_KEY, select_device
    if str(conf.get(DEVICE_KEY) or "cuda") == "cpu":
        return device_id
    dev = select_device(conf, device_id)
    return int(dev.index or 0)
