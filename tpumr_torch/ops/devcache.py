"""Device-resident cache for kernel side inputs (the K-Means centroids).

Counterpart of ``tpumr/ops/devcache.py``. Every map task of a job reads the
same centroids; they are uploaded once per (tag, device) and served from
device memory after. Keyed by ``(tag, torch device)`` where the JAX package
keyed by ``jax.config.jax_default_device``. One byte-budgeted
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
