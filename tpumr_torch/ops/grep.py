"""Grep's map: the matches of ``tpumr.grep.pattern`` in each record,
counted on the host.

Counterpart of ``tpumr/ops/grep.py``: the pattern runs record by record
(``re.finditer``), so no match crosses a line; the batch path counts them
per split and emits one record per distinct match.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Any, Iterable

import numpy as np

from tpumr_torch.mapred.api import Mapper
from tpumr_torch.ops.registry import KernelMapper, register_kernel


def _pattern(conf: Any) -> "tuple[re.Pattern[bytes], int]":
    pat = conf.get("tpumr.grep.pattern")
    if not pat:
        raise ValueError("tpumr.grep.pattern not set")
    return re.compile(pat.encode()), conf.get_int("tpumr.grep.group", 0)


class GrepCpuMapper(Mapper):
    def configure(self, conf: Any) -> None:
        self._re, self._group = _pattern(conf)

    def map(self, key, value, output, reporter):
        data = value.encode() if isinstance(value, str) else value
        for m in self._re.finditer(data):
            output.collect(m.group(self._group).decode("utf-8", "replace"), 1)


class GrepKernel(KernelMapper):
    """A host kernel: no launch, its ``map_batch`` runs on the host batch."""

    name = "grep"
    cpu_mapper_class = GrepCpuMapper

    def map_batch(self, batch, conf, task) -> Iterable[tuple]:
        regex, group = _pattern(conf)
        counts: Counter = Counter()
        mv = memoryview(np.ascontiguousarray(batch.value_data))
        offs = batch.value_offsets
        for i in range(batch.num_records):
            for m in regex.finditer(mv[offs[i]:offs[i + 1]]):
                counts[bytes(m.group(group))] += 1
        for match, n in counts.items():
            yield match.decode("utf-8", errors="replace"), n


register_kernel(GrepKernel())
