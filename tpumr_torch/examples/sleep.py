"""SleepJob: maps and reduces that only sleep, for slot accounting, the
scheduler and the hung-task reaper.

Counterpart of ``tpumr/examples/sleep.py``: ``-m`` maps (``NLineInputFormat``
over one line a map) that sleep ``--map-ms`` and emit ``(0, 0)``, and
``-r`` reduces that sleep ``--reduce-ms`` and write nothing. ``--tpu`` names
the ``sleep`` kernel mapper, so that the accelerator slots take maps too.
``--hang-map IDX`` makes map IDX's first ``--hang-attempts`` attempts stop
reporting progress for good, polling only the kill flag, so that
``mapred.task.timeout`` must reap them and a later attempt completes the
job. Unlike the JAX package's kernel, the port's ``sleep`` kernel hangs
too: on a runner with accelerator slots only, the hang map lands there.
``-D tpumr_torch.device=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Iterable

from tpumr_torch.examples import (add_conf_option, apply_conf_option,
                                  register)
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred.api import Mapper, Reducer, Reporter
from tpumr_torch.mapred.ids import TaskAttemptID
from tpumr_torch.mapred.input_formats import NLineInputFormat
from tpumr_torch.mapred.job_client import run_job
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.ops.registry import KernelMapper, register_kernel


def _sleep_or_hang(conf: Any, reporter: Reporter) -> None:
    """One map's wait: for good, polling only the kill flag, where this is
    a hang attempt of the hang map (``tpumr.sleep.hang.map``, its first
    ``tpumr.sleep.hang.attempts`` attempts); else ``tpumr.sleep.map.ms`` in
    slices that poll it."""
    try:
        attempt = TaskAttemptID.parse(
            str(conf.get("tpumr.task.attempt.id") or "")).attempt
    except (ValueError, IndexError):
        attempt = 0
    if (conf.get_int("tpumr.task.partition", -1)
            == conf.get_int("tpumr.sleep.hang.map", -1)
            and attempt < conf.get_int("tpumr.sleep.hang.attempts", 1)):
        while True:
            reporter.raise_if_aborted()
            time.sleep(0.05)
    deadline = time.monotonic() + conf.get_int("tpumr.sleep.map.ms",
                                               100) / 1000.0
    while time.monotonic() < deadline:
        reporter.raise_if_aborted()
        time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))


class SleepMapper(Mapper):
    def configure(self, conf) -> None:
        self._conf = conf

    def map(self, key, value, output, reporter):
        _sleep_or_hang(self._conf, reporter)
        output.collect(0, 0)


class SleepKernel(KernelMapper):
    """The accelerator slot's sleep: host work, no launch."""

    name = "sleep"
    cpu_mapper_class = SleepMapper

    def map_batch(self, batch, conf, task) -> Iterable[tuple]:
        _sleep_or_hang(conf, getattr(task, "reporter", None) or Reporter())
        yield 0, 0


register_kernel(SleepKernel())


class SleepReducer(Reducer):
    def configure(self, conf) -> None:
        self._ms = conf.get_int("tpumr.sleep.reduce.ms", 100)

    def reduce(self, key, values, output, reporter):
        for _ in values:
            pass
        time.sleep(self._ms / 1000.0)


@register("sleep", "N sleeping maps + R sleeping reduces (scheduler probe)")
def sleep(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples sleep")
    ap.add_argument("-m", "--maps", type=int, default=4)
    ap.add_argument("-r", "--reduces", type=int, default=1)
    ap.add_argument("--map-ms", type=int, default=100)
    ap.add_argument("--reduce-ms", type=int, default=100)
    ap.add_argument("--tpu", action="store_true",
                    help="name the sleep kernel mapper (accelerator slots)")
    ap.add_argument("--hang-map", type=int, default=-1, metavar="IDX",
                    help="map IDX stops reporting progress (the reaper's "
                         "probe: mapred.task.timeout must fail it)")
    ap.add_argument("--hang-attempts", type=int, default=1,
                    help="how many of the hang map's attempts hang "
                         "(default 1: the re-run succeeds)")
    ap.add_argument("--work", default="mem:///tmp/sleep",
                    help="scratch URI for the job's input and output (a "
                         "file:// one for a cluster in another process)")
    add_conf_option(ap)
    args = ap.parse_args(argv)
    inp = f"{args.work.rstrip('/')}/in.txt"
    FileSystem.get(inp).write_bytes(
        inp, b"".join(b"%d\n" % i for i in range(args.maps)))
    conf = JobConf()
    conf.set_job_name("sleep")
    conf.set_input_paths(inp)
    conf.set_output_path(f"{args.work.rstrip('/')}/out")
    conf.set_input_format(NLineInputFormat)
    conf.set("mapred.line.input.format.linespermap", 1)
    conf.set("tpumr.sleep.map.ms", args.map_ms)
    conf.set("tpumr.sleep.reduce.ms", args.reduce_ms)
    if args.hang_map >= 0:
        conf.set("tpumr.sleep.hang.map", args.hang_map)
        conf.set("tpumr.sleep.hang.attempts", args.hang_attempts)
    conf.set_mapper_class(SleepMapper)
    if args.tpu:
        conf.set_map_kernel("sleep")
    conf.set_reducer_class(SleepReducer)
    conf.set_num_reduce_tasks(args.reduces)
    apply_conf_option(conf, args.defs)
    return 0 if run_job(conf).successful else 1
