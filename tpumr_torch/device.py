"""Device selection for the port, its no-fallback rule, and full-f32
products.

Counterpart of ``tpumr/mapred/tpu_runner.py::_select_device``. The port runs
on ``cuda`` unless the caller asks for the CPU, through a ``device=``
argument or the conf key ``tpumr_torch.device=cpu`` (as the CPU tests do).
Asked for ``cuda`` where there is none, it raises; it never carries on
quietly on the CPU.
"""

from __future__ import annotations

from typing import Any

#: conf key naming the port's device: "cuda" (the default), "cuda:<i>" or "cpu"
DEVICE_KEY = "tpumr_torch.device"


def select_device(conf: Any, dev_id: int = -1) -> torch.device:
    """The device a task bound to accelerator slot ``dev_id`` runs on:
    ``cuda:(dev_id % torch.cuda.device_count())`` (``cuda:0`` for
    ``dev_id < 0``), or the CPU when ``conf`` asks for it."""
    import torch
    requested = conf.get(DEVICE_KEY)
    dev = torch.device(requested or "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{DEVICE_KEY}={requested!r}: the port runs on "
                         "'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           f"available; set {DEVICE_KEY}=cpu to run on the "
                           "CPU")
    if dev.index is not None:
        return dev
    return torch.device("cuda", dev_id % torch.cuda.device_count()
                        if dev_id >= 0 else 0)


def full_f32_products() -> None:
    """Keep every f32 matrix product in full f32 (TF32 off): TF32 keeps
    about three decimal digits, which would move near-tie K-Means
    assignments and the matmul job's products away from the f32
    reference. Idempotent; the port's f32 products call it, so none
    depends on which module was imported first."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
