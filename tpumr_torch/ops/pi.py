"""Monte-Carlo pi: each input record ``"<seed> <n>"`` becomes the count of
n uniform points of the unit square that fall in the quarter disc.

Counterpart of ``tpumr/ops/pi.py``. The JAX package draws a block with
``jax.random`` and counts it with ``jnp``, outside any Pallas kernel
(``:23-44``), so the port's device path is torch code, not a hand kernel:
:func:`count_inside` draws from a ``torch.Generator`` of its own on the
batch's device, seeded with the seed masked to uint32 as the JAX package
masks it, in chunks of a fixed :data:`CHUNK` samples, so a (seed, n) gives
the same count on every run. torch's Philox cannot repeat threefry's bits:
the device path agrees with the JAX package's in distribution, not draw for
draw. The host paths (:class:`PiCpuMapper`, ``map_batch_cpu``) are numpy
copies that draw from ``np.random.default_rng(seed)`` and give the JAX
package's counts exactly.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Iterable

import numpy as np
import torch

from tpumr_torch.device import select_device
from tpumr_torch.mapred.api import Mapper
from tpumr_torch.ops.registry import KernelMapper, register_kernel

#: samples drawn and counted per step of :func:`count_inside` (128 MB of
#: f32 pairs on the card)
CHUNK = 1 << 24


def _parse(value: Any) -> tuple[int, int]:
    s = value.decode() if isinstance(value, (bytes, bytearray)) else str(value)
    seed_s, n_s = s.split()
    return int(seed_s), int(n_s)


def count_inside(seed: int, n: int, device: torch.device) -> torch.Tensor:
    """How many of n points drawn uniformly from [0, 1)² on ``device`` lie
    in the quarter disc, as an int64 scalar tensor there; nothing waits for
    the device. The draws come from a generator seeded with
    ``seed & 0xFFFFFFFF``, CHUNK samples at a time."""
    count_inside.launches += 1
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0xFFFFFFFF)
    inside = torch.zeros((), dtype=torch.int64, device=device)
    for lo in range(0, n, CHUNK):
        pts = torch.rand((min(CHUNK, n - lo), 2), generator=g, device=device)
        inside += (pts.square_().sum(dim=1) <= 1.0).sum()
    return inside


#: calls of count_inside, one per sample block (the card's work of a map)
count_inside.launches = 0


def count_inside_numpy(seed: int, n: int) -> int:
    """The host count, drawn from ``np.random.default_rng(seed)`` in f32:
    the JAX package's ``PiCpuMapper`` arithmetic."""
    pts = np.random.default_rng(seed).random((n, 2), dtype=np.float32)
    return int(((pts * pts).sum(axis=1) <= 1.0).sum())


class PiCpuMapper(Mapper):
    def map(self, key, value, output, reporter):
        seed, n = _parse(value)
        output.collect("inside", count_inside_numpy(seed, n))
        output.collect("total", n)


class PiSamplerKernel(KernelMapper):
    name = "pi-sampler"
    cpu_mapper_class = PiCpuMapper

    def map_batch_launch(self, batch, conf, task):
        """Enqueue one count per record on the task's device, the records
        grouped by sample count; the state is ``{"inside": [one int64
        tensor per distinct n], "total": samples}``, left on the device
        for the runner's one fetch."""
        device = select_device(conf, getattr(task, "tpu_device_id", -1))
        groups: "dict[int, list[int]]" = defaultdict(list)
        for i in range(batch.num_records):
            seed, n = _parse(batch.value(i))
            groups[n].append(seed)
        counts = [torch.stack([count_inside(s, n, device) for s in seeds])
                  for n, seeds in groups.items()]
        return {"inside": counts,
                "total": sum(n * len(s) for n, s in groups.items())}

    def map_batch_drain(self, fetched, conf, task) -> Iterable[tuple]:
        yield "inside", sum(int(c.sum()) for c in fetched["inside"])
        yield "total", int(fetched["total"])

    def map_batch_cpu(self, batch, conf, task) -> Iterable[tuple]:
        """The host twin for CPU slots: every block through numpy."""
        inside = total = 0
        for i in range(batch.num_records):
            seed, n = _parse(batch.value(i))
            inside += count_inside_numpy(seed, n)
            total += n
        yield "inside", inside
        yield "total", total


register_kernel(PiSamplerKernel())
