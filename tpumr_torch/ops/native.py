"""Build and load the port's hand-written CUDA kernels.

No counterpart in ``tpumr/``: the JAX package's one kernel is compiled by
Pallas inside ``pl.pallas_call``. Here every source under
``tpumr_torch/csrc/`` (:data:`SOURCES`) has a plain C entry point. At first
use one ``nvcc`` call compiles them all for ``sm_90a`` into one shared
library under ``tpumr_torch/build/`` (listed in ``.gitignore``), and
``ctypes`` loads it. A library newer than every source is reused. Nothing is
built or loaded at import time: the CPU tests import every module of the
package on a machine without ``nvcc``. A build that cannot run or fails, and
a library that does not load, raise :class:`KernelBuildError`, which the
task layer classes ``compile`` (``mapred/task.classify_exception``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every CUDA source of the port, all built into :data:`LIBRARY`
SOURCES = tuple(os.path.join(_PKG, "csrc", name) for name in
                ("kmeans_assign.cu", "kmeans_assign_partials.cu"))
LIBRARY = os.path.join(_PKG, "build", "libtpumr_torch_kernels.so")
#: the compiler's output of the last build (registers, spills per kernel)
BUILD_LOG = os.path.join(_PKG, "build", "nvcc.log")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


class KernelBuildError(RuntimeError):
    """The port's CUDA kernels could not be built or loaded."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
             else shutil.which("nvcc"))
    if not found or not os.path.exists(found):
        raise KernelBuildError("nvcc not found: the port's CUDA kernels are "
                               "built from tpumr_torch/csrc on a machine "
                               "with the CUDA toolkit (set CUDA_HOME)")
    return found


def stale() -> bool:
    """Whether the library is missing or older than any of its sources."""
    if not os.path.exists(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(os.path.getmtime(src) > built for src in SOURCES)


def build() -> float:
    """Compile the kernel library if it is stale. Returns the seconds it
    took; raises with the compiler's output if the build fails."""
    t0 = time.monotonic()
    if not stale():
        return 0.0
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    output = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise KernelBuildError(f"CUDA kernel build failed: nvcc exit "
                               f"{proc.returncode}\n{output}")
    with open(BUILD_LOG, "w") as f:
        f.write(output)
    os.replace(tmp, LIBRARY)
    return time.monotonic() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built if stale. Each entry point returns a
    cudaError_t as an int:

    - ``kmeans_assign(points, centroids, c2, part_d2, part_j, out, n, d,
      k, bn, splits, resident, stream)``;
    - ``kmeans_assign_partials(points, centroids, ids, partials, sums,
      counts, n, d, k, tile, blocks, device, stream)``, launched as
      ``kmeans.fused_plan`` says;
    - ``kmeans_assign_partials_occupancy(d, k, device, &per_sm)``, what a
      plan's ``blocks_per_sm`` is held against.
    """
    global _lib
    with _lock:
        if _lib is None:
            build()
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError as e:
                raise KernelBuildError(f"CUDA kernel library did not load: "
                                       f"{e}") from e
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.kmeans_assign.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                          i, p]
            lib.kmeans_assign.restype = ctypes.c_int
            lib.kmeans_assign_partials.argtypes = [p, p, p, p, p, p, i, i,
                                                   i, i, i, i, p]
            lib.kmeans_assign_partials.restype = ctypes.c_int
            lib.kmeans_assign_partials_occupancy.argtypes = [
                i, i, i, ctypes.POINTER(ctypes.c_int)]
            lib.kmeans_assign_partials_occupancy.restype = ctypes.c_int
            _lib = lib
        return _lib
