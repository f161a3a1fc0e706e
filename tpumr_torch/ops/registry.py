"""Kernel-mapper registry and the launch/drain protocol.

Counterpart of ``tpumr/ops/registry.py``. A job names its kernel mapper in
``tpumr.map.kernel``; the runner resolves the name here.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

import numpy as np
import torch


def _leaves(state: Any) -> "list[torch.Tensor]":
    """The tensors of a state, in order: a tensor, or a tuple, list or dict
    of states; any other leaf (a Python int) holds no tensor."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    if isinstance(state, dict):
        return [t for s in state.values() for t in _leaves(s)]
    return []


def _rebuild(state: Any, arrays: Iterator[np.ndarray]) -> Any:
    """``state`` with each tensor replaced by the next of ``arrays``."""
    if isinstance(state, torch.Tensor):
        return next(arrays)
    if isinstance(state, (tuple, list)):
        return type(state)(_rebuild(s, arrays) for s in state)
    if isinstance(state, dict):
        return {k: _rebuild(s, arrays) for k, s in state.items()}
    return state


def fetch_to_host(states: "list[Any]") -> "list[Any]":
    """Every tensor of every state brought to the host in ONE device-to-host
    copy: the tensors are concatenated as bytes on the device, copied once
    (one synchronisation), and cut back into numpy arrays of their own
    dtype and shape. A state is a tensor or a tuple, list or dict of them;
    other leaves (matmul's ``row0``) come back as they are."""
    flat = [t for state in states for t in _leaves(state)]
    if not flat:
        return list(states)
    blob = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in flat]).cpu().numpy()
    arrays, pos = [], 0
    for t in flat:
        nbytes = t.numel() * t.element_size()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        arrays.append(blob[pos:pos + nbytes].view(np_dtype).reshape(
            tuple(t.shape)))
        pos += nbytes
    it = iter(arrays)
    return [_rebuild(state, it) for state in states]


class KernelMapper:
    """A whole-batch mapper.

    A device kernel implements the launch/drain protocol:
    ``map_batch_launch(batch, conf, task)`` takes a staged batch (a
    :class:`DenseBatch` whose ``values`` tensor lies on the device, or a
    host :class:`RecordBatch`), enqueues its device work and returns its
    state (device tensors in a tuple, list or dict, beside plain Python
    values) without waiting for them; ``map_batch_drain(fetched, conf,
    task)`` turns that state, fetched to the host with numpy arrays for
    tensors, into the task's (key, value) records. The runner fetches a
    whole window of tasks' states in one copy (:func:`fetch_to_host`). A
    kernel whose output a dense output file will hold offers it for the
    output chain through ``device_output_rows(state)``
    (``tpumr_torch/mapred/device_output.py``).

    A host kernel (``wordcount``, ``grep``) has no launch: it overrides
    :meth:`map_batch`, which the runner calls on the host batch.
    ``map_batch_cpu(batch, conf, task)`` is the vectorized host twin for
    CPU map slots, on a numpy batch; ``cpu_mapper_class`` the per-record
    mapper of the same job.
    """

    #: registry name
    name: str = ""
    #: the per-record CPU mapper of a job that names this kernel
    cpu_mapper_class: "type | None" = None
    #: the vectorized host twin for CPU slots, where there is one
    map_batch_cpu: Any = None

    def map_batch_launch(self, batch: Any, conf: Any, task: Any) -> Any:
        """Enqueue the device work of one batch and return its state; the
        default (no launch protocol) returns None."""
        return None

    def map_batch_drain(self, fetched: Any, conf: Any, task: Any
                        ) -> Iterable[tuple]:
        raise NotImplementedError

    @classmethod
    def supports_launch(cls) -> bool:
        return cls.map_batch_launch is not KernelMapper.map_batch_launch

    def map_batch(self, batch: Any, conf: Any, task: Any) -> Iterable[tuple]:
        """Launch, one device-to-host copy, drain."""
        state = self.map_batch_launch(batch, conf, task)
        if state is None:
            raise NotImplementedError(
                f"kernel {self.name!r} has no launch and does not override "
                "map_batch")
        return self.map_batch_drain(fetch_to_host([state])[0], conf, task)


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


def kernels() -> list[str]:
    return sorted(_REGISTRY)
