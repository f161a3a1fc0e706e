"""Streaming's runners: a child process per task that reads records on its
stdin and writes records on its stdout.

Counterpart of ``tpumr/streaming/pipe_runner.py``. The contracts are the
JAX package's:

- records cross the pipes as ``key<TAB>value<NL>`` lines (a text input's
  byte offset is not sent, ``stream.map.input.ignoreKey``), and an output
  line splits at its first ``stream.map.output.field.separator``; or, with
  ``-io typedbytes`` (``stream.{map,reduce}.{input,output}``), as typed
  bytes pairs (``streaming/typedbytes.py``);
- a reduce child gets the whole sorted partition as records and groups the
  keys itself;
- the child's stderr carries ``reporter:counter:<group>,<name>,<amount>``
  and ``reporter:status:<message>`` (``:44-67``), which reach the task's
  counters and status; every other line passes through to stderr;
- the job conf reaches the child's environment, dots turned into
  underscores (:func:`_child_env`).

One child a task: :class:`StreamMapRunner` ends it after the split,
:class:`StreamReducer` at ``close()``, and a failed reduce's ``abort()``
kills it. :class:`StreamCombiner` is built anew for every combine (one
spill, one merge), as ``mapred/combine.combined_stream`` builds each
combiner, and hands its child's output on only at ``close()``, after the
child has ended, so that its reader thread never writes into the stream
that the combine is yielding. Each record the child writes and each
reporter line is a sign of life for the node runner's hung-task reaper,
and a wait for the child's end polls the attempt's kill flag. Children
start through ``subprocess.Popen`` (fork and exec), never a
``multiprocessing`` fork of a process that may hold a CUDA context, as
``pipes/application.py`` starts them; a killed child is reaped.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
from typing import Any, BinaryIO

from tpumr_torch.mapred.api import (MapRunnable, OutputCollector, Reducer,
                                    Reporter, TaskKilledError)
from tpumr_torch.streaming.typedbytes import read_pairs, write_pair

#: seconds between two looks at the kill flag while a child finishes
KILL_POLL_S = 0.2


def _child_env(conf: Any) -> dict:
    """The process environment with every scalar conf value added under
    its key, dots turned into underscores."""
    env = dict(os.environ)
    for k, v in conf:
        if isinstance(v, (str, int, float, bool)):
            env[str(k).replace(".", "_")] = str(v)
    return env


def _stderr_pump(stream: BinaryIO, reporter: Reporter) -> threading.Thread:
    """Reads the child's stderr: reporter lines update the task, others
    pass through."""

    def run() -> None:
        for raw in stream:
            line = raw.decode("utf-8", "replace").rstrip("\n")
            if line.startswith("reporter:counter:"):
                try:
                    group, name, amount = line[len("reporter:counter:"):] \
                        .split(",", 2)
                    reporter.incr_counter(group, name, int(amount))
                    reporter.keepalive()
                    continue
                except ValueError:
                    pass
            elif line.startswith("reporter:status:"):
                reporter.set_status(line[len("reporter:status:"):])
                continue
            print(line, file=sys.stderr)

    t = threading.Thread(target=run, name="stream-stderr", daemon=True)
    t.start()
    return t


class _StreamProcess:
    """One child with its stdin writer and its stdout and stderr readers.
    ``in_mode`` and ``out_mode`` are each "text" or "typedbytes"."""

    def __init__(self, conf: Any, command: str, output: OutputCollector,
                 reporter: Reporter, in_mode: str = "text",
                 out_mode: str = "text") -> None:
        self.sep = conf.get("stream.map.output.field.separator", "\t") \
            .encode("utf-8")
        self.in_mode = in_mode
        self.out_mode = out_mode
        self.reporter = reporter
        self.proc = subprocess.Popen(
            shlex.split(command), env=_child_env(conf),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        self._err_thread = _stderr_pump(self.proc.stderr, reporter)
        self._out_error: "BaseException | None" = None
        self._out_thread = threading.Thread(
            target=self._drain_stdout, args=(output,),
            name="stream-stdout", daemon=True)
        self._out_thread.start()

    def _drain_stdout(self, output: OutputCollector) -> None:
        try:
            if self.out_mode == "typedbytes":
                for k, v in read_pairs(self.proc.stdout):
                    output.collect(k, v)
                    self.reporter.keepalive()
                return
            for raw in self.proc.stdout:
                line = raw.rstrip(b"\n")
                if not line:
                    continue
                head, _, tail = line.partition(self.sep)
                output.collect(head.decode("utf-8", "replace"),
                               tail.decode("utf-8", "replace"))
                self.reporter.keepalive()
        except BaseException as e:  # noqa: BLE001 — raised by finish()
            self._out_error = e
            # go on reading, so that a child still writing never blocks
            # on a full pipe
            try:
                while self.proc.stdout.read(65536):
                    pass
            except (OSError, ValueError):
                pass

    def write_record(self, key: Any, value: Any) -> None:
        if self.in_mode == "typedbytes":
            write_pair(self.proc.stdin, key, value)
            return
        self.proc.stdin.write(f"{key}\t{value}\n".encode("utf-8"))

    def write_line(self, value: Any) -> None:
        self.proc.stdin.write(f"{value}\n".encode("utf-8"))

    def _join_readers(self) -> None:
        """Wait for the child to close its output, polling the kill
        flag."""
        for t in (self._out_thread, self._err_thread):
            while t.is_alive():
                t.join(KILL_POLL_S)
                if t.is_alive() and self.reporter.aborted():
                    self.kill()
                    raise TaskKilledError("attempt killed while its "
                                          "streaming child ran")

    def finish(self, what: str) -> None:
        """Close the child's input, read its output to the end and reap
        it; raises on a non-zero exit or an output that does not parse."""
        try:
            self.proc.stdin.close()
        except BrokenPipeError:
            pass      # the child stopped reading: its exit says why
        self._join_readers()
        rc = self.proc.wait()
        if rc != 0:
            raise RuntimeError(f"streaming {what} exited rc={rc} "
                               "(subprocess failed with code)")
        if self._out_error is not None:
            raise RuntimeError(
                f"streaming {what} output protocol error: "
                f"{self._out_error}") from self._out_error

    def kill(self) -> None:
        """End the child now and reap it (a failed or killed task)."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        for f in (self.proc.stdin, self.proc.stdout, self.proc.stderr):
            try:
                f.close()
            except (OSError, ValueError):
                pass


class StreamMapRunner(MapRunnable):
    """The map side: every record of the split to the child
    (``stream.map.command``), every record it writes to the collector."""

    def __init__(self) -> None:
        self.conf: Any = None

    def configure(self, conf: Any) -> None:
        self.conf = conf

    def run(self, reader, output, reporter, task_ctx=None) -> None:
        command = self.conf.get("stream.map.command")
        if not command:
            raise ValueError("streaming job missing stream.map.command")
        in_mode = self.conf.get("stream.map.input", "text")
        out_mode = self.conf.get("stream.map.output", "text")
        # a text input sends the line alone; typed bytes always a pair
        ignore_key = in_mode != "typedbytes" and self.conf.get_boolean(
            "stream.map.input.ignoreKey",
            self.conf.get_input_format().__name__ == "TextInputFormat")
        child = _StreamProcess(self.conf, command, output, reporter,
                               in_mode=in_mode, out_mode=out_mode)
        try:
            for key, value in reader:
                if ignore_key:
                    child.write_line(value)
                else:
                    child.write_record(key, value)
        except BrokenPipeError:
            child.finish("mapper")   # raises where the child failed
            raise
        except BaseException:
            child.kill()
            raise
        child.finish("mapper")


class StreamReducer(Reducer):
    """The reduce side: the partition's records, in order, to one child
    (``stream.reduce.command``), started at the first group."""

    COMMAND_KEY = "stream.reduce.command"

    def __init__(self) -> None:
        self.conf: Any = None
        self._child: "_StreamProcess | None" = None

    def configure(self, conf: Any) -> None:
        self.conf = conf

    def _start(self, output: OutputCollector, reporter: Reporter) -> None:
        command = self.conf.get(self.COMMAND_KEY)
        if not command:
            raise ValueError(f"streaming job missing {self.COMMAND_KEY}")
        self._child = _StreamProcess(
            self.conf, command, output, reporter,
            in_mode=self.conf.get("stream.reduce.input", "text"),
            out_mode=self.conf.get("stream.reduce.output", "text"))

    def reduce(self, key, values, output, reporter) -> None:
        if self._child is None:
            self._start(output, reporter)
        for v in values:
            self._child.write_record(key, v)

    def close(self) -> None:
        if self._child is not None:
            try:
                self._child.finish("reducer")
            finally:
                self._child = None

    def abort(self) -> None:
        """A failed attempt: kill the child instead of waiting for it."""
        if self._child is not None:
            try:
                self._child.kill()
            finally:
                self._child = None


class StreamCombiner(StreamReducer):
    """A combiner through a child (``stream.combine.command``): one child
    for each combine, its records handed on at ``close()``."""

    COMMAND_KEY = "stream.combine.command"

    def __init__(self) -> None:
        super().__init__()
        self._held: "list[tuple[Any, Any]]" = []
        self._output: "OutputCollector | None" = None

    def reduce(self, key, values, output, reporter) -> None:
        if self._child is None:
            self._output = output
            self._start(OutputCollector(
                lambda k, v: self._held.append((k, v))), reporter)
        for v in values:
            self._child.write_record(key, v)

    def close(self) -> None:
        super().close()
        held, self._held = self._held, []
        for k, v in held:
            self._output.collect(k, v)
