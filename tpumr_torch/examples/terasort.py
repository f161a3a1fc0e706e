"""TeraGen, TeraSort and TeraValidate.

Counterpart of ``tpumr/examples/terasort.py``: 100-byte records,
a 10-byte key of printable bytes and a 90-byte value led by the 10-digit
row number, generated from the row number alone; sorted through a sampled
partition file and ``TotalOrderPartitioner`` (the host shuffle) or on the
card (``--device-shuffle``, ``mapred/device_shuffle.py``); then checked for
global order. The records are SequenceFiles with ``bytes`` keys and values.
In a pipeline (teragen, sort, validate as one graph) the sort stage's
sampling runs in the master through :func:`pipeline_sort_hook`.

Each program takes ``-D key=value`` for the job conf, as the port's other
examples do; ``-D tpumr_torch.device=cpu`` runs it on the CPU. Without it
the job runs on ``cuda``, or raises where there is none.
"""

from __future__ import annotations

import argparse

import numpy as np

from tpumr_torch.examples import (add_conf_option, apply_conf_option,
                                  register)
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred.api import (IdentityReducer, Mapper, RawComparator,
                                    Reducer)
from tpumr_torch.mapred.input_formats import (NLineInputFormat,
                                              SequenceFileInputFormat)
from tpumr_torch.mapred.job_client import run_job
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.output_formats import SequenceFileOutputFormat
from tpumr_torch.mapred.total_order import (TotalOrderPartitioner,
                                            sample_input,
                                            write_partition_file)

KEY_LEN = 10
VALUE_LEN = 90
_PRINTABLE_LO, _PRINTABLE_HI = 0x20, 0x7E


def gen_records(row_start: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Rows ``[row_start, row_start + n)``: ``(keys [n, 10], values [n,
    90])`` uint8, the keys drawn from ``default_rng(0xC0FFEE ^
    row_start)``, each value the 10-digit row number then dots."""
    rng = np.random.default_rng(0xC0FFEE ^ row_start)
    keys = rng.integers(_PRINTABLE_LO, _PRINTABLE_HI + 1,
                        size=(n, KEY_LEN), dtype=np.uint8)
    values = np.full((n, VALUE_LEN), ord("."), dtype=np.uint8)
    if row_start + n > 10 ** 10:
        raise ValueError("row id exceeds the 10-digit row field")
    rows = row_start + np.arange(n, dtype=np.int64)
    divs = 10 ** np.arange(9, -1, -1, dtype=np.int64)
    values[:, :10] = (rows[:, None] // divs % 10 + ord("0")).astype(np.uint8)
    return keys, values


class TeraGenMapper(Mapper):
    """Input record ``"<row_start> <num_rows>"``: emits those rows, whole
    where the collector takes fixed-width rows."""

    def map(self, key, value, output, reporter):
        s = value.decode() if isinstance(value, (bytes, bytearray)) else value
        row_start, n = (int(x) for x in s.split())
        keys, values = gen_records(row_start, n)
        output.collect_fixed_rows(np.concatenate([keys, values], axis=1),
                                  KEY_LEN)


class TeraSortMapper(Mapper):
    """The identity: the framework sorts."""

    identity_map = True

    def map(self, key, value, output, reporter):
        output.collect(key, value)


class TeraValidateMapper(Mapper):
    """The order check of one part file: emits ``(part ordinal, (first
    key, last key, misordered pairs))`` at close, so the reducer can check
    the boundaries between parts."""

    def configure(self, conf) -> None:
        self._first: "bytes | None" = None
        self._last: "bytes | None" = None
        self._errors = 0
        self._out = None
        self._ordinal = max(0, conf.get_int("tpumr.task.partition", -1))

    def map(self, key, value, output, reporter):
        self._out = output
        if self._first is None:
            self._first = key
        elif key < self._last:
            self._errors += 1
        self._last = key

    def map_record_batch(self, batch, output, reporter) -> None:
        """The same check over the whole split at once: Python's bytes
        order, on zero-padded keys with the length breaking ties."""
        n = batch.num_records
        if n == 0:
            return
        self._out = output
        klens = batch.key_offsets[1:] - batch.key_offsets[:-1]
        self._first = batch.key(0)
        self._last = batch.key(n - 1)
        if n > 1:
            width = int(klens.max())
            if width == 0:   # every key empty: nothing can be out of order
                self._errors = 0
                return
            keys, _ = batch.padded_keys(width)
            diff = keys[1:].astype(np.int16) - keys[:-1].astype(np.int16)
            nz = diff != 0
            has = nz.any(axis=1)
            at_first = diff[np.arange(n - 1), nz.argmax(axis=1)]
            inverted = (has & (at_first < 0)) | \
                (~has & (klens[1:] < klens[:-1]))
            self._errors = int(inverted.sum())

    def close(self) -> None:
        if self._out is not None and self._first is not None:
            self._out.collect(self._ordinal,
                              (self._first, self._last, self._errors))


class TeraValidateReducer(Reducer):
    """One group per part, in part order: reports misordered keys within
    a part and across a boundary."""

    def __init__(self) -> None:
        self._prev_last: "bytes | None" = None
        self._bad = 0

    def reduce(self, key, values, output, reporter):
        for first, last, errors in values:
            if errors:
                self._bad += errors
                output.collect("misordered-in-part", errors)
            if self._prev_last is not None and first < self._prev_last:
                self._bad += 1
                output.collect("misordered-across-parts", 1)
            self._prev_last = last


@register("teragen", "generate 100-byte terasort records")
def teragen(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples teragen")
    ap.add_argument("num_rows", type=int)
    ap.add_argument("output")
    ap.add_argument("-m", "--maps", type=int, default=2)
    add_conf_option(ap)
    args = ap.parse_args(argv)
    out = args.output.rstrip("/")
    fs = FileSystem.get(out)
    inp = f"{out}.teragen-in/rows.txt"
    per = args.num_rows // args.maps
    lines, start = [], 0
    for m in range(args.maps):
        n = per + (args.num_rows - per * args.maps if m == args.maps - 1
                   else 0)
        lines.append(f"{start} {n}\n")
        start += n
    FileSystem.get(inp).write_bytes(inp, "".join(lines).encode())
    conf = JobConf()
    conf.set_job_name("teragen")
    conf.set_input_paths(inp)
    conf.set_output_path(out)
    conf.set_input_format(NLineInputFormat)
    conf.set("mapred.line.input.format.linespermap", 1)
    conf.set_mapper_class(TeraGenMapper)
    conf.set_output_format(SequenceFileOutputFormat)
    conf.set_num_reduce_tasks(0)
    apply_conf_option(conf, args.defs)
    ok = run_job(conf).successful
    fs.delete(f"{out}.teragen-in", recursive=True)
    return 0 if ok else 1


@register("terasort", "globally sort terasort records")
def terasort(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples terasort")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-r", "--reduces", type=int, default=2)
    ap.add_argument("--device-shuffle", action="store_true",
                    help="sort on the device instead of the host shuffle")
    add_conf_option(ap)
    args = ap.parse_args(argv)
    conf = make_terasort_conf(args.input, args.output, args.reduces,
                              device_shuffle=args.device_shuffle)
    apply_conf_option(conf, args.defs)
    return 0 if run_job(conf).successful else 1


def make_terasort_conf(input_path: str, output_path: str, reduces: int,
                       device_shuffle: bool = False) -> JobConf:
    """The terasort job: raw byte order, a partition file of 1,000 sampled
    keys at ``<output>.partitions`` with ``TotalOrderPartitioner``, and
    with ``device_shuffle`` the sort on the device."""
    conf = JobConf()
    conf.set_job_name("terasort")
    conf.set_input_paths(input_path)
    conf.set_output_path(output_path)
    conf.set_input_format(SequenceFileInputFormat)
    conf.set_mapper_class(TeraSortMapper)
    conf.set_reducer_class(IdentityReducer)
    conf.set_output_format(SequenceFileOutputFormat)
    conf.set_output_key_comparator_class(RawComparator)
    conf.set_num_reduce_tasks(reduces)
    samples = sample_input(conf, num_samples=1000)
    write_partition_file(conf, output_path.rstrip("/") + ".partitions",
                         samples, reduces)
    conf.set_partitioner_class(TotalOrderPartitioner)
    if device_shuffle:
        conf.set_device_shuffle(KEY_LEN, VALUE_LEN)
    return conf


def pipeline_sort_hook(conf: dict, upstreams: dict) -> None:
    """``conf_hook`` of a pipeline's sort stage: the sampling that
    ``terasort`` runs in the client between jobs needs teragen's output,
    so in a pipeline the master runs it just before it submits the stage,
    whose input is already wired to that output. Writes
    ``<output>.partitions`` and names ``TotalOrderPartitioner``."""
    jc = JobConf()
    for k, v in conf.items():
        jc.set(k, v)
    reduces = int(conf.get("mapred.reduce.tasks", 1) or 1)
    samples = sample_input(jc, num_samples=1000)
    write_partition_file(jc, str(conf["mapred.output.dir"]).rstrip("/")
                         + ".partitions", samples, reduces)
    for k, v in jc:
        conf[k] = v   # the partition file's key among them
    conf["mapred.partitioner.class"] = \
        "tpumr_torch.mapred.total_order.TotalOrderPartitioner"


@register("teravalidate", "validate that terasort output is globally sorted")
def teravalidate(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples teravalidate")
    ap.add_argument("input", help="terasort output directory")
    ap.add_argument("output")
    add_conf_option(ap)
    args = ap.parse_args(argv)
    conf = JobConf()
    conf.set_job_name("teravalidate")
    parts = sorted(str(st.path) for st in
                   FileSystem.get(args.input).list_files(args.input)
                   if st.path.name.startswith("part"))
    conf.set_input_paths(*parts)
    conf.set_output_path(args.output)
    conf.set_input_format(SequenceFileInputFormat)
    conf.set("mapred.min.split.size", 1 << 60)   # one split per part file
    conf.set_mapper_class(TeraValidateMapper)
    conf.set_reducer_class(TeraValidateReducer)
    conf.set_num_reduce_tasks(1)
    apply_conf_option(conf, args.defs)
    if not run_job(conf).successful:
        return 1
    fs = FileSystem.get(args.output)
    bad = [line for st in fs.list_files(args.output)
           if st.path.name.startswith("part")
           for line in fs.read_bytes(st.path).decode().splitlines()]
    if bad:
        print("VALIDATION FAILED:")
        for b in bad:
            print(" ", b)
        return 1
    print("Output is globally sorted.")
    return 0
