"""The device sort of the device-shuffled reduce, on one device.

Counterpart of ``tpumr/parallel/device_sort.py``: ``key_columns``,
``_lex_gt`` and ``compute_dest`` (``:36-76``), each on numpy arrays as there
and on torch tensors, and the one-device branch of ``device_partition_sort``
(``:160-184``): only the sort keys visit the device, as packed key columns;
a stable lexicographic argsort runs there (:func:`argsort_keys`, the
counterpart of ``_argsort_keys``, ``:126-134``); the permutation comes back,
and the caller gathers its rows on the host.

A key of ``klen`` bytes becomes ``ceil(klen / 4)`` big-endian ``uint32``
columns, zero-padded at the end, so byte order is column order. numpy
holds them as ``uint32``; torch, whose ``uint32`` support is partial, as
``int64`` of the same values. The argsort is stable ``torch.sort`` passes
from the least to the most significant column, each over the column as an
order-preserving ``int32`` (the value less 2^31), so equal keys keep their
input order, as ``np.lexsort`` keeps it. The JAX package pads to a power
of two against recompiles; the port needs no padding.

The mesh exchange (``:186-227`` with ``parallel/shuffle.py``) is not
ported: one GPU never takes it.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch


def num_key_columns(klen: int) -> int:
    return -(-klen // 4)


def key_columns(records: Any, klen: int) -> Any:
    """``[n, >= klen]`` uint8 to ``[n, ceil(klen / 4)]`` big-endian key
    columns: ``uint32`` from a numpy array, ``int64`` of the same values
    from a tensor (on its device)."""
    ncols = num_key_columns(klen)
    n = records.shape[0]
    if isinstance(records, torch.Tensor):
        cols = torch.zeros((n, ncols), dtype=torch.int64,
                           device=records.device)
        for b in range(ncols * 4):
            c = b // 4
            cols[:, c] <<= 8
            if b < klen:
                cols[:, c] |= records[:, b].to(torch.int64)
        return cols
    padded = np.zeros((n, ncols * 4), dtype=np.uint8)
    padded[:, :klen] = records[:, :klen]
    return padded.view(">u4").astype(np.uint32)


def _lex_gt(key_cols: Any, splitter_cols: Any) -> Any:
    """``[n, c] > [c]`` lexicographically: ``[n]`` bool, the key strictly
    greater."""
    n = key_cols.shape[0]
    if isinstance(key_cols, torch.Tensor):
        gt = torch.zeros(n, dtype=torch.bool, device=key_cols.device)
        eq = torch.ones(n, dtype=torch.bool, device=key_cols.device)
    else:
        gt = np.zeros(n, dtype=bool)
        eq = np.ones(n, dtype=bool)
    for c in range(key_cols.shape[1]):
        gt = gt | (eq & (key_cols[:, c] > splitter_cols[c]))
        eq = eq & (key_cols[:, c] == splitter_cols[c])
    return gt


def compute_dest(key_cols: Any, splitter_cols: Any) -> Any:
    """Each key's range: the number of splitters it is greater than (a key
    equal to a splitter stays in the lower range, as
    ``TotalOrderPartitioner`` puts it). ``int32``."""
    if isinstance(key_cols, torch.Tensor):
        dest = torch.zeros(key_cols.shape[0], dtype=torch.int32,
                           device=key_cols.device)
        for j in range(splitter_cols.shape[0]):
            dest += _lex_gt(key_cols, splitter_cols[j]).to(torch.int32)
        return dest
    dest = np.zeros(key_cols.shape[0], dtype=np.int32)
    for j in range(splitter_cols.shape[0]):
        dest += _lex_gt(key_cols, splitter_cols[j]).astype(np.int32)
    return dest


def argsort_keys(cols: torch.Tensor) -> torch.Tensor:
    """Stable ascending lexicographic argsort of ``[n, ncols]`` key
    columns (column 0 most significant, values in ``[0, 2^32)``), on the
    columns' device: one stable ``torch.sort`` per column, from the last.
    Returns the ``int64`` permutation."""
    if cols.is_cuda:
        argsort_keys.launches += 1
    perm = None
    for c in range(cols.shape[1] - 1, -1, -1):
        col = cols[:, c] if perm is None else cols[perm, c]
        key = (col - 2 ** 31).to(torch.int32)   # same order as the uint32
        idx = torch.sort(key, stable=True).indices
        perm = idx if perm is None else perm[idx]
    if perm is None:
        return torch.arange(cols.shape[0], device=cols.device)
    return perm


#: device argsorts launched on the card
argsort_keys.launches = 0


def device_partition_sort(kcols: np.ndarray, device: torch.device,
                          stages: "dict[str, float] | None" = None
                          ) -> "tuple[np.ndarray, torch.Tensor]":
    """The one-device sort: upload the ``uint32`` key columns, argsort
    them on ``device``, download the permutation. Returns ``(order, the
    columns on the device)``. ``stages`` receives the seconds of the
    upload, the argsort and the download, and on ``cuda`` the argsort's
    device milliseconds (CUDA events)."""
    stages = {} if stages is None else stages
    t = time.monotonic()
    # the uint32 bits go up as int32 and widen to int64 on the device
    bits = torch.from_numpy(np.ascontiguousarray(kcols).view(np.int32))
    cols = bits.to(device).to(torch.int64) & 0xFFFFFFFF
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages["upload_s"] = time.monotonic() - t
    t = time.monotonic()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        perm = argsort_keys(cols)
        end.record()
        end.synchronize()
        stages["argsort_device_ms"] = start.elapsed_time(end)
    else:
        perm = argsort_keys(cols)
    stages["argsort_s"] = time.monotonic() - t
    t = time.monotonic()
    order = perm.cpu().numpy()
    del perm
    stages["download_s"] = time.monotonic() - t
    return order, cols
