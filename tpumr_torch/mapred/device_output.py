"""Device-resident output chaining: a job's kernel output stays on the card
for the next job that reads its files.

Counterpart of ``tpumr/mapred/device_output.py``. The protocol (host-side
bookkeeping; the tensor never moves):

1. the device runner, after ``map_batch_launch``, asks the kernel for
   ``device_output_rows(state)``, the device tensor whose host image the
   task's output file will hold, and :func:`offer`\\ s it under the attempt
   id (only when the job's output format claims device rows,
   ``DenseNpyOutputFormat``);
2. the dense output writer, on close, writes the ``.npy`` part file from
   the fetched host rows, then :func:`claim`\\ s the tensor and
   :func:`publish`\\ es it keyed by a fingerprint of the written bytes
   (size, mtime, and 4 KB at each end; the commit rename keeps the mtime);
3. a later job staging a dense split of that file computes the same
   fingerprint from an 8 KB read (:func:`lookup`) and, on a hit, slices the
   split's rows from the resident tensor on the device: no read of the
   split, no copy to the card. The first hit per file also checks the
   publisher's sha1 of the whole file, so a file that only shares the
   fingerprint never serves another file's rows.

Entries live in the per-device split cache (``tpumr.tpu.split.cache.mb``).
Residency is never a correctness dependency: with nothing resident the
consumer reads the file.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any

import numpy as np
import torch

#: fingerprint window at each end of the file
_FP_WINDOW = 4096

_lock = threading.Lock()
#: attempt id -> device rows awaiting the writer's claim (bounded: only
#: dense-output jobs offer, and a crashed writer's entry is evicted)
_pending: dict[str, torch.Tensor] = {}
_PENDING_CAP = 16
#: set once anything was published in this process: until then
#: :func:`lookup` returns at once, so jobs that never chain read nothing
_published_any = False
#: (path, size, mtime, fingerprint) identities whose whole content matched
#: the publisher's sha1; ``_verify_locks`` lets one task per identity hash
#: the file while the others wait for its answer
_verified: set = set()
_verify_locks: dict = {}


def numpy_dtype(dtype: torch.dtype) -> "np.dtype | None":
    """The numpy dtype of a torch dtype, or None where numpy has none
    (bfloat16). ``str(tensor.dtype)`` is ``"torch.float32"``, never equal
    to numpy's ``"float32"``: compare these instead."""
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        return None


def offer(attempt_id: str, rows: torch.Tensor) -> None:
    with _lock:
        while len(_pending) >= _PENDING_CAP:
            _pending.pop(next(iter(_pending)))
        _pending[attempt_id] = rows


def claim(attempt_id: str) -> "torch.Tensor | None":
    with _lock:
        return _pending.pop(attempt_id, None)


def fingerprint(head: bytes, tail: bytes, size: int, mtime: float) -> str:
    """Cache-key identity of one written file: size, mtime and the two end
    windows. It only selects a candidate; :func:`lookup` checks the whole
    content on the first hit."""
    h = hashlib.sha1()
    h.update(str(size).encode())
    h.update(repr(mtime).encode())
    h.update(head)
    h.update(tail)
    return h.hexdigest()


def head_tail(data: bytes) -> "tuple[bytes, bytes, int]":
    """The (head, tail, size) fingerprint inputs of in-memory bytes: the
    same bytes :func:`lookup` reads from the file."""
    head = data[:_FP_WINDOW]
    tail = data[max(_FP_WINDOW, len(data) - _FP_WINDOW):] \
        if len(data) > _FP_WINDOW else b""
    return head, tail, len(data)


def _cache(conf: Any, device: torch.device):
    from tpumr_torch.mapred.gpu_runner import split_cache
    return split_cache(device,
                       conf.get_int("tpumr.tpu.split.cache.mb", 2048) << 20)


def publish(conf: Any, rows: torch.Tensor, head: bytes, tail: bytes,
            size: int, mtime: float, full_sha: "str | None" = None) -> None:
    """Register ``rows`` as the resident image of a just-written file, in
    the split cache of the tensor's own device. ``full_sha`` is the sha1 of
    the whole file, which the consumer's first hit checks."""
    global _published_any
    if not isinstance(rows, torch.Tensor):
        raise TypeError(f"publish takes a torch.Tensor, got "
                        f"{type(rows).__name__}")
    key = ("devout", fingerprint(head, tail, size, mtime))
    _cache(conf, rows.device).put(key, {"rows": rows, "sha": full_sha},
                                  rows.numel() * rows.element_size())
    _published_any = True


def lookup(conf: Any, device: torch.device, fs: Any, path: str, size: int,
           mtime: float) -> "torch.Tensor | None":
    """The whole-file resident tensor for ``path`` on ``device``, or None.
    Costs one 8 KB read, and nothing until this process has published an
    output; the first hit per on-disk identity also reads the whole file to
    check the publisher's sha1. A read that raises ``OSError`` gives None:
    the consumer then reads the file through its input format."""
    if not _published_any:
        return None
    if not conf.get_boolean("tpumr.tpu.output.cache", True):
        return None
    try:
        with fs.open(path) as f:
            head = f.read(_FP_WINDOW)
            if size > _FP_WINDOW:
                f.seek(max(_FP_WINDOW, size - _FP_WINDOW))
                tail = f.read(_FP_WINDOW)
            else:
                tail = b""
    except OSError:
        return None              # the caller reads the file itself
    fp = fingerprint(head, tail, size, mtime)
    entry = _cache(conf, device).get(("devout", fp))
    if entry is None:
        return None
    sha = entry["sha"]
    ident = (path, size, mtime, fp)
    if sha is not None and ident not in _verified:
        with _lock:
            vlock = _verify_locks.setdefault(ident, threading.Lock())
        with vlock:
            if ident not in _verified:
                h = hashlib.sha1()
                try:
                    with fs.open(path) as f:
                        for chunk in iter(lambda: f.read(1 << 20), b""):
                            h.update(chunk)
                except OSError:
                    return None
                if h.hexdigest() != sha:
                    return None          # an alias: read the file instead
                with _lock:
                    if len(_verified) > 4096:
                        _verified.clear()
                        _verify_locks.clear()
                    _verified.add(ident)
    return entry["rows"]
