"""The framework side of pipes tasks: the map runners, the reducer and the
partitioner.

Counterpart of ``tpumr/pipes/runner.py``, whose classes are the
reference's ``PipesMapRunner``, ``PipesGPUMapRunner``, ``PipesReducer`` and
``PipesPartitioner``. The JAX package renamed the accelerator runner
``PipesTPUMapRunner``; here it keeps Hadoop's name,
:class:`PipesGPUMapRunner` (``PipesGPUMapRunner.java:40-118``): the same
record loop as :class:`PipesMapRunner`, with the job's second cached
executable and the card's CUDA ordinal as ``argv[1]``
(``application.cuda_ordinal``). ``pipes/submitter.setup_pipes_job`` names it
as the job's ``mapred.map.runner.tpu.class``, which ``map_task`` reads for
an accelerator-slot task.

Input reaches a map child two ways (``:105-127`` there): piped, one
MAP_ITEM frame per record of the split (``tpumr.pipes.piped.input``, the
default), or not, where the child gets the split's dict as JSON in
RUN_MAP and reads the split itself (the reference's own record reader,
``wordcount-nopipe``). Keys and values cross as bytes: ``bytes`` as they
are, anything else as its UTF-8 text; what comes back is text where it
decodes.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import zlib
from typing import Any

from tpumr_torch.mapred.api import (MapRunnable, OutputCollector, Partitioner,
                                    Reducer, Reporter)
from tpumr_torch.pipes.application import (Application, cuda_ordinal,
                                           select_executable)


def encode(obj: Any) -> bytes:
    """A framework value for the child: bytes as they are, anything else as
    its UTF-8 text (what a Text writable would carry)."""
    if isinstance(obj, bytes):
        return obj
    return str(obj).encode("utf-8")


def decode(data: bytes) -> Any:
    """A child's bytes for the framework: text where they decode as UTF-8,
    so that text outputs stay readable, else the bytes."""
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError:
        return data


def _cache_root(conf: Any) -> str:
    """Where the job's executables are localised: ``tpumr.cache.dir`` (the
    node runner sets its own), else a directory under the temp dir."""
    root = conf.get("tpumr.cache.dir")
    if not root:
        root = os.path.join(tempfile.gettempdir(), "tpumr_torch-cache")
        conf.set("tpumr.cache.dir", root)
    return root


def _wire_conf_items(conf: Any) -> dict:
    return {k: v for k, v in conf
            if isinstance(v, (str, int, float, bool)) or v is None}


class _ChildPartitionStash(threading.local):
    value: "int | None" = None


_stash = _ChildPartitionStash()


class PipesPartitioner(Partitioner):
    """The partition the child chose (PARTITIONED_OUTPUT), where it chose
    one, else a CRC32 hash of the key's bytes."""

    def get_partition(self, key: Any, value: Any, num_partitions: int) -> int:
        part = _stash.value
        if part is not None:
            _stash.value = None
            return part % num_partitions
        return zlib.crc32(encode(key)) % num_partitions


class _UplinkCollector:
    """OUTPUT and PARTITIONED_OUTPUT into the task's collector (the
    reference's ``OutputHandler``)."""

    def __init__(self, output: OutputCollector) -> None:
        self._output = output

    def collect(self, kb: bytes, vb: bytes) -> None:
        self._output.collect(decode(kb), decode(vb))

    def partitioned_collect(self, part: int, kb: bytes, vb: bytes) -> None:
        _stash.value = part
        try:
            self._output.collect(decode(kb), decode(vb))
        finally:
            _stash.value = None


class PipesMapRunner(MapRunnable):
    """A CPU-slot map through the job's first cached executable."""

    RUN_ON_TPU = False

    def __init__(self) -> None:
        self.conf: Any = None

    def configure(self, conf: Any) -> None:
        self.conf = conf

    def run(self, reader, output, reporter, task_ctx=None) -> None:
        conf = self.conf
        run_on_tpu = self.RUN_ON_TPU or bool(
            getattr(task_ctx, "run_on_tpu", False))
        ordinal = (cuda_ordinal(conf, getattr(task_ctx, "tpu_device_id", 0))
                   if run_on_tpu else -1)
        executable = select_executable(conf, _cache_root(conf), run_on_tpu)
        app = Application(conf, executable, _UplinkCollector(output),
                          reporter, run_on_tpu=run_on_tpu,
                          device_ordinal=ordinal)
        try:
            down = app.downlink
            down.start()
            down.set_job_conf(_wire_conf_items(conf))
            split = getattr(task_ctx, "split", None) or {}
            piped = conf.get_boolean("tpumr.pipes.piped.input", True)
            down.run_map(json.dumps(split).encode("utf-8"),
                         int(conf.get("mapred.reduce.tasks", 1)),
                         piped_input=piped)
            if piped:
                for key, value in reader:
                    down.map_item(encode(key), encode(value))
            down.close()
            app.wait_for_finish()
        except BaseException:
            app.cleanup(kill=True)
            raise
        finally:
            app.cleanup()


class PipesGPUMapRunner(PipesMapRunner):
    """An accelerator-slot map: the job's second cached executable, with
    the card's CUDA ordinal as ``argv[1]`` (Hadoop's
    ``PipesGPUMapRunner``)."""

    RUN_ON_TPU = True


class PipesReducer(Reducer):
    """A reduce through the job's first cached executable, started at the
    first key; REDUCE_KEY and REDUCE_VALUE frames, then CLOSE and DONE at
    :meth:`close`."""

    def __init__(self) -> None:
        self.conf: Any = None
        self._app: "Application | None" = None

    def configure(self, conf: Any) -> None:
        self.conf = conf

    def _ensure_app(self, output: OutputCollector,
                    reporter: Reporter) -> Application:
        if self._app is None:
            executable = select_executable(self.conf,
                                           _cache_root(self.conf), False)
            self._app = Application(self.conf, executable,
                                    _UplinkCollector(output), reporter)
            down = self._app.downlink
            down.start()
            down.set_job_conf(_wire_conf_items(self.conf))
            down.run_reduce(0, piped_output=True)
        return self._app

    def reduce(self, key, values, output, reporter) -> None:
        app = self._ensure_app(output, reporter)
        app.downlink.reduce_key(encode(key))
        for v in values:
            app.downlink.reduce_value(encode(v))

    def close(self) -> None:
        if self._app is None:
            return
        try:
            self._app.downlink.close()
            self._app.wait_for_finish()
        finally:
            self._app.cleanup()
            self._app = None

    def abort(self) -> None:
        """A failed reduce attempt: the child is killed and reaped."""
        if self._app is not None:
            self._app.abort()
            self._app = None
