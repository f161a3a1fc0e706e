"""Device-resident cache for kernel side inputs (K-Means centroids, matmul B).

Counterpart of ``tpumr/ops/devcache.py``. Every map task of a job reads the
same side input (the K-Means centroids, the matmul B); it is uploaded once
per (tag, device) and served from device memory after. Keyed by
``(tag, str(torch device))`` where the JAX package keyed by
``jax.config.jax_default_device``. One byte-budgeted
:class:`~tpumr_torch.mapred.gpu_runner.DeviceSplitCache`
(``tpumr.ops.device.cache.mb``, default 1024, fixed at first use).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch

_lock = threading.Lock()
_cache = None           # lazily-built DeviceSplitCache


def _cache_for(conf: Any):
    global _cache
    with _lock:
        if _cache is None:
            from tpumr_torch.mapred.gpu_runner import DeviceSplitCache
            budget_mb = (conf.get_int("tpumr.ops.device.cache.mb", 1024)
                         if conf is not None else 1024)
            _cache = DeviceSplitCache(budget_mb * 1024 * 1024)
        return _cache


def device_cached(tag: str, device: torch.device,
                  upload: Callable[[], torch.Tensor],
                  conf: Any = None) -> torch.Tensor:
    """The tensor cached under ``(tag, device)``; on a miss, ``upload()``
    makes it (the one host-to-device copy) and the cache keeps it."""
    key = (tag, str(device))
    cache = _cache_for(conf)
    hit = cache.get(key)
    if hit is not None:
        return hit
    t = upload()
    cache.put(key, t, t.numel() * t.element_size())
    return t


def clear_device_cache(tag_prefix: "str | None" = None) -> None:
    with _lock:
        cache = _cache
    if cache is None:
        return
    if tag_prefix is None:
        cache.clear()
    else:
        cache.drop_where(lambda k: k[0].startswith(tag_prefix))


def inventory(max_tags: int = 32) -> "dict[str, int]":
    """Resident tag -> bytes summed over devices, most recent first, at
    most ``max_tags`` tags; empty before the cache's first use."""
    with _lock:
        cache = _cache
    if cache is None:
        return {}
    tags: "dict[str, int]" = {}
    for (tag, _device), nbytes in reversed(cache.snapshot()):
        if tag in tags:
            tags[tag] += nbytes
        elif len(tags) < max_tags:
            tags[tag] = nbytes
    return tags


def occupancy() -> "dict[str, Any]":
    """Entry count, resident bytes, and bytes per tag family (the tag's
    prefix before the first ``:``)."""
    with _lock:
        cache = _cache
    if cache is None:
        return {"entries": 0, "bytes": 0, "families": {}}
    snap = cache.snapshot()
    families: "dict[str, int]" = {}
    for (tag, _device), nbytes in snap:
        family = tag.split(":", 1)[0]
        families[family] = families.get(family, 0) + nbytes
    return {"entries": len(snap), "bytes": sum(b for _k, b in snap),
            "families": families}
