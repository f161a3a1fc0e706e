"""The external-process task tier ("pipes"): user binaries that run map
and reduce logic in a child process and speak a framed binary protocol
over a loopback socket, with dual CPU and GPU executables chosen per task,
the path by which the reference reaches CUDA.

Counterpart of ``tpumr/pipes/__init__.py``. Its names load on first use
(PEP 562), so that a child importing ``tpumr_torch.pipes.child`` loads
neither torch nor numpy.
"""

from __future__ import annotations

import importlib

_EXPORTS = {"Application": "application", "PipesMapRunner": "runner",
            "PipesGPUMapRunner": "runner", "PipesReducer": "runner",
            "PipesPartitioner": "runner", "Submitter": "submitter",
            "setup_pipes_job": "submitter"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
