"""Kernel-mapper registry and the launch/drain protocol.

Counterpart of ``tpumr/ops/registry.py``. A job names its kernel mapper in
``tpumr.map.kernel``; the runner resolves the name here.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch


def fetch_to_host(states: "list[tuple[torch.Tensor, ...]]"
                  ) -> "list[tuple[np.ndarray, ...]]":
    """Every tensor of every state brought to the host in ONE device-to-host
    copy: the tensors are concatenated as bytes on the device, copied once
    (one synchronisation), and cut back into numpy arrays of their own
    dtype and shape."""
    flat = [t for state in states for t in state]
    if not flat:
        return [tuple() for _ in states]
    blob = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in flat]).cpu().numpy()
    arrays, pos = [], 0
    for t in flat:
        nbytes = t.numel() * t.element_size()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        arrays.append(blob[pos:pos + nbytes].view(np_dtype).reshape(
            tuple(t.shape)))
        pos += nbytes
    out, i = [], 0
    for state in states:
        out.append(tuple(arrays[i:i + len(state)]))
        i += len(state)
    return out


class KernelMapper:
    """A whole-batch device mapper.

    ``map_batch_launch(batch, conf, task)`` takes a :class:`DenseBatch`
    whose ``values`` tensor lies on the device, enqueues the kernel and
    returns a tuple of device tensors without waiting for them;
    ``map_batch_drain(fetched, conf, task)`` turns that tuple, fetched to
    the host as numpy arrays, into the task's few (key, value) records.
    The runner fetches a whole window of tasks' states in one copy
    (:func:`fetch_to_host`). ``map_batch_cpu(batch, conf, task)`` is the
    vectorized host twin for CPU map slots, on a numpy batch.
    """

    #: registry name
    name: str = ""

    def map_batch_launch(self, batch: Any, conf: Any, task: Any
                         ) -> "tuple[torch.Tensor, ...]":
        raise NotImplementedError

    def map_batch_drain(self, fetched: Any, conf: Any, task: Any
                        ) -> Iterable[tuple]:
        raise NotImplementedError

    def map_batch(self, batch: Any, conf: Any, task: Any) -> Iterable[tuple]:
        """Launch, one device-to-host copy, drain."""
        state = self.map_batch_launch(batch, conf, task)
        return self.map_batch_drain(fetch_to_host([state])[0], conf, task)

    def map_batch_cpu(self, batch: Any, conf: Any, task: Any
                      ) -> Iterable[tuple]:
        raise NotImplementedError


_REGISTRY: dict[str, KernelMapper] = {}


def register_kernel(kernel: KernelMapper) -> KernelMapper:
    if not kernel.name:
        raise ValueError("kernel needs a name")
    _REGISTRY[kernel.name] = kernel
    return kernel


def get_kernel(name: str) -> KernelMapper:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel mapper {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None
