"""Build and load the port's hand-written CUDA kernel.

No counterpart in ``tpumr/``: the JAX package's one kernel is compiled by
Pallas inside ``pl.pallas_call``. Here it is ``tpumr_torch/csrc/
kmeans_assign.cu`` with a plain C entry point. At first use ``nvcc`` compiles
it for ``sm_90a`` into a shared library under ``tpumr_torch/build/`` (listed
in ``.gitignore``), and ``ctypes`` loads it. A library newer than its source
is reused. Nothing is built or loaded at import time: the CPU tests import
every module of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "kmeans_assign.cu")
LIBRARY = os.path.join(_PKG, "build", "libkmeans_assign.so")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
             else shutil.which("nvcc"))
    if not found or not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernel is built "
                           "from tpumr_torch/csrc on a machine with the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build() -> float:
    """Compile the kernel library if it is missing or older than its
    source. Returns the seconds it took; raises with the compiler's output
    if the build fails."""
    t0 = time.monotonic()
    if os.path.exists(LIBRARY) and \
            os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return 0.0
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: nvcc exit "
                           f"{proc.returncode}\n"
                           f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, LIBRARY)
    return time.monotonic() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built if stale. Its entry point
    ``kmeans_assign(points, centroids, out, n, d, k, stream)`` returns the
    launch's cudaError_t as an int."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.kmeans_assign.argtypes = [p, p, p, i, i, i, p]
            lib.kmeans_assign.restype = ctypes.c_int
            _lib = lib
        return _lib
