"""Example programs: iterative K-Means.

Counterpart of ``tpumr/examples/basic.py:48-89`` (the shared options and
``.npy`` helpers) and ``:182-238`` (``kmeans``). The JAX package's
``matmul`` program is not ported: it writes C through the text output, one
``str()`` of a block per record, which numpy abbreviates with "...". The
matmul job itself runs through ``run_job`` with ``DenseNpyOutputFormat``.
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
from tpumr_torch.mapred.input_formats import DenseInputFormat, read_npy_header
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.local_runner import run_job
from tpumr_torch.ops.kmeans import CentroidReducer, clear_centroid_cache

__all__ = ["CentroidReducer", "kmeans", "load_npy", "load_npy_rows",
           "save_npy"]


def _common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-r", "--reduces", type=int, default=1)
    ap.add_argument("--cpu-only", action="store_true",
                    help=f"run on the CPU through the numpy batch maps "
                         f"({DEVICE_KEY}=cpu); without it the job runs on "
                         f"cuda or raises")
    ap.add_argument("-D", dest="defs", action="append", default=[],
                    metavar="k=v")


def _apply(conf: JobConf, args: argparse.Namespace) -> None:
    """The shared options. In the JAX package ``--cpu-only`` withholds
    ``tpumr.local.run.on.tpu``; in the port the device decides where a
    kernel's maps run, so ``--cpu-only`` asks for the CPU and leaves that
    key unset (the numpy batch runner)."""
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


@register("kmeans", "iterative K-Means clustering (the north-star job)")
def kmeans(argv: list[str]) -> int:
    """Iterative K-Means: each round is one job (assignment and partial
    sums in the maps, centroid means in the reduce) that rewrites one
    centroid file, so the centroid caches are cleared every round."""
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
        clear_centroid_cache()
        conf = JobConf()
        conf.set_input_paths(args.points)
        conf.set_output_path(f"{out}/iter{it}")
        conf.set_input_format(DenseInputFormat)
        conf.set("tpumr.dense.split.rows", args.split_rows)
        conf.set("tpumr.kmeans.centroids", cent_path)
        conf.set_map_kernel("kmeans-assign")
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
