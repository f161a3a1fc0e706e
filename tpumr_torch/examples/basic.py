"""Example programs: wordcount, grep, pi, kmeans and matmul.

Counterpart of ``tpumr/examples/basic.py``: ``LongSumReducer`` (``:29``),
the shared options and ``.npy`` helpers (``:48-86``) and the programs
(``:88-265``). Without ``--cpu-only`` a program runs its kernel mapper on
``cuda`` (or raises where there is none); ``--cpu-only`` asks for the CPU
(``tpumr_torch.device=cpu``) and sets the per-record mapper, as the JAX
package's ``--cpu-only`` sets its mappers (``kmeans`` keeps its kernel, whose
numpy twin then runs on the CPU slots).
"""

from __future__ import annotations

import argparse
import ast
import io
import sys
from typing import Any, Iterator

import numpy as np

from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.examples import register
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred.api import Reducer
from tpumr_torch.mapred.input_formats import (DenseInputFormat,
                                              NLineInputFormat,
                                              RawTextInputFormat,
                                              TextInputFormat,
                                              read_npy_header)
from tpumr_torch.mapred.job_client import run_job
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.ops.grep import GrepCpuMapper
from tpumr_torch.ops.kmeans import CentroidReducer, KMeansCpuMapper
from tpumr_torch.ops.matmul import MatmulCpuMapper
from tpumr_torch.ops.pi import PiCpuMapper
from tpumr_torch.ops.wordcount import WordCountCpuMapper

__all__ = ["CentroidReducer", "LongSumReducer", "grep", "kmeans", "load_npy",
           "load_npy_rows", "matmul", "pi", "save_npy", "wordcount"]


class LongSumReducer(Reducer):
    """The sum of a key's values (``mapred/lib/LongSumReducer.java``)."""

    def reduce(self, key, values, output, reporter):
        output.collect(key, sum(values))


def _common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-r", "--reduces", type=int, default=1)
    ap.add_argument("--cpu-only", action="store_true",
                    help=f"run on the CPU ({DEVICE_KEY}=cpu) through the "
                         f"per-record mapper; without it the job runs its "
                         f"kernel on cuda or raises")
    ap.add_argument("-D", dest="defs", action="append", default=[],
                    metavar="k=v")


def _apply(conf: JobConf, args: argparse.Namespace) -> None:
    """The shared options. In the JAX package ``--cpu-only`` withholds
    ``tpumr.local.run.on.tpu``; in the port the device decides where a
    kernel's maps run, so ``--cpu-only`` asks for the CPU and leaves that
    key unset (the CPU slots' runners)."""
    conf.set_num_reduce_tasks(args.reduces)
    for kv in args.defs:
        k, _, v = kv.partition("=")
        conf.set(k.strip(), v.strip())
    if args.cpu_only:
        conf.set(DEVICE_KEY, "cpu")
    else:
        conf.set("tpumr.local.run.on.tpu", True)


def save_npy(fs: FileSystem, path: str, arr: np.ndarray) -> None:
    buf = io.BytesIO()
    np.save(buf, arr)
    fs.write_bytes(path, buf.getvalue())


def load_npy(fs: FileSystem, path: str) -> np.ndarray:
    return np.load(io.BytesIO(fs.read_bytes(path)))


def load_npy_rows(fs: FileSystem, path: str, k: int) -> np.ndarray:
    """The first ``k`` rows, by a ranged read: seeding k centroids reads
    k rows, not the whole (possibly 100M-point) array."""
    with fs.open(path) as f:
        shape, dtype, data_start = read_npy_header(f)
        n_rows = min(k, shape[0])
        row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        f.seek(data_start)
        raw = f.read(n_rows * row_bytes)
    return np.frombuffer(raw, dtype=dtype).reshape((n_rows,) + shape[1:])


def _read_pairs(fs: FileSystem, out_dir: str) -> Iterator[tuple[str, str]]:
    for st in fs.list_files(out_dir):
        if st.path.name.startswith("part"):
            for line in fs.read_bytes(st.path).decode().splitlines():
                k, _, v = line.partition("\t")
                yield k, v


@register("wordcount", "count words in the input files")
def wordcount(argv: list[str]) -> int:
    """The ``wordcount`` kernel over ``RawTextInputFormat`` splits, or with
    ``--cpu-only`` the per-record mapper over ``TextInputFormat`` lines;
    ``LongSumReducer`` as combiner and reducer."""
    ap = argparse.ArgumentParser(prog="tpumr_torch examples wordcount")
    ap.add_argument("input")
    ap.add_argument("output")
    _common(ap)
    args = ap.parse_args(argv)
    conf = JobConf()
    conf.set_input_paths(*args.input.split(","))
    conf.set_output_path(args.output)
    if args.cpu_only:
        conf.set_input_format(TextInputFormat)
        conf.set_mapper_class(WordCountCpuMapper)
    else:
        conf.set_input_format(RawTextInputFormat)
        conf.set_map_kernel("wordcount")
    conf.set_reducer_class(LongSumReducer)
    conf.set_combiner_class(LongSumReducer)
    _apply(conf, args)
    return 0 if run_job(conf).successful else 1


@register("grep", "count matches of a regex in the input files")
def grep(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples grep")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("regex")
    ap.add_argument("group", nargs="?", type=int, default=0)
    _common(ap)
    args = ap.parse_args(argv)
    conf = JobConf()
    conf.set_input_paths(*args.input.split(","))
    conf.set_output_path(args.output)
    conf.set_input_format(TextInputFormat)
    conf.set("tpumr.grep.pattern", args.regex)
    conf.set("tpumr.grep.group", args.group)
    if args.cpu_only:
        conf.set_mapper_class(GrepCpuMapper)
    else:
        conf.set_map_kernel("grep")
    conf.set_reducer_class(LongSumReducer)
    conf.set_combiner_class(LongSumReducer)
    _apply(conf, args)
    return 0 if run_job(conf).successful else 1


@register("pi", "estimate pi by Monte-Carlo sampling on the device")
def pi(argv: list[str]) -> int:
    """One map per block of ``n_samples`` points (``NLineInputFormat``, one
    ``"<seed> <n>"`` line each, seeds from 1000), each block drawn and
    counted on the card (``pi-sampler``); prints the estimate."""
    ap = argparse.ArgumentParser(prog="tpumr_torch examples pi")
    ap.add_argument("n_maps", type=int)
    ap.add_argument("n_samples", type=int, help="samples per map")
    ap.add_argument("--work", default="mem:///tmp/pi",
                    help="scratch URI for job input/output")
    _common(ap)
    args = ap.parse_args(argv)
    fs = FileSystem.get(args.work)
    inp = f"{args.work.rstrip('/')}/in.txt"
    out = f"{args.work.rstrip('/')}/out"
    fs.write_bytes(inp, "".join(f"{1000 + i} {args.n_samples}\n"
                                for i in range(args.n_maps)).encode())
    conf = JobConf()
    conf.set_input_paths(inp)
    conf.set_output_path(out)
    conf.set_input_format(NLineInputFormat)
    conf.set("mapred.line.input.format.linespermap", 1)
    if args.cpu_only:
        conf.set_mapper_class(PiCpuMapper)
    else:
        conf.set_map_kernel("pi-sampler")
    conf.set_reducer_class(LongSumReducer)
    _apply(conf, args)
    if not run_job(conf).successful:
        return 1
    counts = dict(_read_pairs(fs, out))
    inside, total = int(counts["inside"]), int(counts["total"])
    print(f"Estimated value of Pi is {4.0 * inside / max(1, total)}")
    return 0


@register("kmeans", "iterative K-Means clustering (the north-star job)")
def kmeans(argv: list[str]) -> int:
    """Iterative K-Means: each round is one job (assignment and partial
    sums in the maps, centroid means in the reduce), submitted where
    ``mapred.job.tracker`` says, that rewrites one centroid file. The
    centroid caches, here and on a runner, check the file's length and
    mtime, so each round reads the file that the last one wrote."""
    ap = argparse.ArgumentParser(prog="tpumr_torch examples kmeans")
    ap.add_argument("points", help=".npy of shape (n, d)")
    ap.add_argument("output", help="output directory URI")
    ap.add_argument("-k", type=int, default=8)
    ap.add_argument("-i", "--iterations", type=int, default=5)
    ap.add_argument("--split-rows", type=int, default=1 << 17)
    _common(ap)
    args = ap.parse_args(argv)
    fs = FileSystem.get(args.output)
    out = args.output.rstrip("/")
    cent_path = f"{out}/centroids.npy"
    seeds = load_npy_rows(FileSystem.get(args.points), args.points, args.k)
    save_npy(fs, cent_path, seeds.astype(np.float32))
    centroids: Any = None
    for it in range(args.iterations):
        conf = JobConf()
        conf.set_job_name(f"kmeans-iter-{it}")
        conf.set_input_paths(args.points)
        conf.set_output_path(f"{out}/iter{it}")
        conf.set_input_format(DenseInputFormat)
        conf.set("tpumr.dense.split.rows", args.split_rows)
        conf.set("tpumr.kmeans.centroids", cent_path)
        # the kernel in both modes: on the CPU its numpy twin runs
        # (CpuBatchMapRunner); -D tpumr.cpu.batch.map=false takes the
        # per-record mapper
        conf.set_map_kernel("kmeans-assign")
        conf.set_mapper_class(KMeansCpuMapper)
        conf.set_reducer_class(CentroidReducer)
        _apply(conf, args)
        if not run_job(conf).successful:
            return 1
        centroids = load_npy(fs, cent_path).copy()
        for key, val in _read_pairs(fs, f"{out}/iter{it}"):
            centroids[int(key)] = np.asarray(ast.literal_eval(val),
                                             dtype=np.float32)
        save_npy(fs, cent_path, centroids)
    print(f"Final centroids written to {cent_path}")
    if centroids is not None:
        np.savetxt(sys.stdout, centroids, fmt="%.4f")
    return 0


@register("matmul", "blocked dense matrix multiply A @ B")
def matmul(argv: list[str]) -> int:
    """C = A @ B by row blocks of A (``matmul-block``, or with
    ``--cpu-only`` the per-record ``MatmulCpuMapper``), as the JAX
    package's program runs it: ``-r`` reduces (one by default, passing the
    records through by first row; ``-r 0`` writes from the maps), through
    the default text output, one ``str()`` of a block (a row with
    ``--cpu-only``) per record, which numpy abbreviates with "..." past
    1,000 elements, so the part files do not hold C. The dense matmul job,
    whose output a following job can read, runs through ``run_job`` with
    ``DenseNpyOutputFormat`` and no reduce."""
    ap = argparse.ArgumentParser(prog="tpumr_torch examples matmul")
    ap.add_argument("a", help=".npy for A (n, k)")
    ap.add_argument("b", help=".npy for B (k, m)")
    ap.add_argument("output")
    ap.add_argument("--split-rows", type=int, default=1 << 14)
    _common(ap)
    args = ap.parse_args(argv)
    conf = JobConf()
    conf.set_input_paths(args.a)
    conf.set_output_path(args.output)
    conf.set_input_format(DenseInputFormat)
    conf.set("tpumr.dense.split.rows", args.split_rows)
    conf.set("tpumr.matmul.b", args.b)
    if args.cpu_only:
        conf.set_mapper_class(MatmulCpuMapper)
    else:
        conf.set_map_kernel("matmul-block")
    conf.set_num_reduce_tasks(0)
    _apply(conf, args)
    return 0 if run_job(conf).successful else 1
