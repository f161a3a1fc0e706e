"""Device-resident cache for kernel side inputs (K-Means centroids, matmul B).

Counterpart of ``tpumr/ops/devcache.py``. Every map task of a job reads the
same side input (the K-Means centroids, the matmul B); it is uploaded once
per (tag, device) and served from device memory after, as long as its
file's length and mtime stay those it was uploaded from. Keyed by
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


def file_stamp(conf: Any, path: str) -> tuple:
    """A file's (length, mtime): the freshness half of a side input's cache
    entry, as the split cache keys staged splits (``gpu_runner``), so that
    a rewritten file is read anew, also by a runner in another process."""
    from tpumr_torch.fs.filesystem import FileSystem
    st = FileSystem.get(path, conf).get_status(path)
    return (st.length, st.mtime)


def device_cached(tag: str, device: torch.device,
                  upload: Callable[[], torch.Tensor],
                  conf: Any = None, *, stamp: tuple) -> torch.Tensor:
    """The tensor cached under ``(tag, device)``; on a miss, ``upload()``
    makes it (the one host-to-device copy) and the cache keeps it.
    ``stamp`` (the source file's length and mtime) is kept beside the
    tensor: an entry whose stamp differs is stale, and is replaced."""
    key = (tag, str(device))
    cache = _cache_for(conf)
    hit = cache.get(key)
    if hit is not None:
        if hit[0] == stamp:
            return hit[1]
        cache.drop_where(lambda k: k == key)
    t = upload()
    cache.put(key, (stamp, t), t.numel() * t.element_size())
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
