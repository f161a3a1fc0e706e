"""Blocked matrix-multiply map kernel.

Counterpart of ``tpumr/ops/matmul.py`` (BASELINE.json config 4). Each map
task owns a row block of A (its dense split) and computes
``C_block = A_block @ B``, with B a side file uploaded once per device
(``ops/devcache``, tag ``matmul-b:``) while the file stays unchanged. The
product is one plain large matrix product: the JAX package hands it to XLA
outside any Pallas kernel, and the port hands it to torch (cuBLAS on the
card). The job writes C
through ``DenseNpyOutputFormat``, and the kernel offers C for the output
chain (:meth:`MatmulBlockKernel.device_output_rows`), so a job that reads
C next finds it on the card.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from tpumr_torch.device import full_f32_products
from tpumr_torch.mapred.api import Mapper
from tpumr_torch.ops.registry import KernelMapper, register_kernel

#: path -> ((length, mtime) of the file read, B)
_b_cache: "dict[str, tuple[tuple, np.ndarray]]" = {}


def _b_file(conf: Any) -> tuple[str, tuple]:
    from tpumr_torch.ops.devcache import file_stamp
    path = conf.get("tpumr.matmul.b")
    if not path:
        raise ValueError("tpumr.matmul.b not set (path to .npy of B)")
    return path, file_stamp(conf, path)


def _load_b(conf: Any) -> np.ndarray:
    from tpumr_torch.fs.filesystem import FileSystem
    from tpumr_torch.mapred.input_formats import load_dense
    path, stamp = _b_file(conf)
    cached = _b_cache.get(path)
    if cached is None or cached[0] != stamp:
        cached = _b_cache[path] = (
            stamp, load_dense(FileSystem.get(path, conf), path))
    return cached[1]


def clear_b_cache() -> None:
    """Drop the host and device copies of every B, to free them: a
    rewritten B is read anew without a clear, since both caches check its
    length and mtime."""
    from tpumr_torch.ops.devcache import clear_device_cache
    _b_cache.clear()
    clear_device_cache("matmul-b:")


def _device_b(conf: Any, device: torch.device) -> torch.Tensor:
    """B on ``device``, uploaded once per (file, device) while the file's
    length and mtime stay the same."""
    from tpumr_torch.ops.devcache import device_cached
    path, stamp = _b_file(conf)
    return device_cached(
        f"matmul-b:{path}", device,
        lambda: torch.from_numpy(np.array(_load_b(conf), order="C"))
        .to(device), conf, stamp=stamp)


def block_matmul(a: torch.Tensor, b: torch.Tensor, bf16: bool = True
                 ) -> torch.Tensor:
    """``a @ b`` as f32, on the operands' device.

    ``bf16`` (the default), as ``tpumr.ops.matmul._matmul_bf16``: both
    operands rounded to bfloat16, products accumulated and returned in f32
    (``preferred_element_type=float32``), not rounded to bf16 as
    ``torch.matmul`` of bf16 tensors would. On the card that is cuBLAS's
    bf16 product with f32 output; on the CPU the bf16-rounded operands in
    an f32 product, which computes the same thing (a product of two bf16
    values is exact in f32). Else, as ``_matmul_f32``: a full f32 product,
    TF32 off."""
    full_f32_products()
    if not bf16:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type == "cuda":
        return torch.mm(a16, b16, out_dtype=torch.float32)
    return torch.matmul(a16.to(torch.float32), b16.to(torch.float32))


class MatmulCpuMapper(Mapper):
    """Per-record CPU mapper: one row of A at a time through numpy (a copy
    of ``tpumr.ops.matmul.MatmulCpuMapper``)."""

    def configure(self, conf: Any) -> None:
        self._b = _load_b(conf)

    def map(self, key, row, output, reporter):
        output.collect(int(key), np.asarray(row) @ self._b)


class MatmulBlockKernel(KernelMapper):
    name = "matmul-block"
    cpu_mapper_class = MatmulCpuMapper

    def map_batch_launch(self, batch, conf, task):
        """Enqueue ``C_block = A_block @ B`` on the batch's device; the state
        is ``{"c": C_block, "row0": first row of the block}``."""
        a = batch.values
        c = block_matmul(a, _device_b(conf, a.device),
                         bf16=conf.get_boolean("tpumr.matmul.bf16", True))
        row0 = int(batch.ids[0]) if batch.ids is not None else 0
        return {"c": c, "row0": row0}

    def map_batch_drain(self, fetched, conf, task) -> Iterable[tuple]:
        yield int(fetched["row0"]), np.asarray(fetched["c"])

    def device_output_rows(self, state):
        """The output chain's rows: C stays on the card for a job that
        reads this job's dense output next."""
        return state["c"]

    def map_batch_cpu(self, batch, conf, task) -> Iterable[tuple]:
        """CPU-slot path on a host numpy batch: the whole block in one f32
        BLAS product, as the JAX package's ``map_batch_cpu``."""
        b = _load_b(conf)
        c = np.asarray(batch.values, np.float32) @ np.asarray(b, np.float32)
        row0 = int(batch.ids[0]) if batch.ids is not None else 0
        yield row0, c


register_kernel(MatmulBlockKernel())
