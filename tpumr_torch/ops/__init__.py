"""Kernel mappers. Importing the package registers every built-in kernel."""

from tpumr_torch.ops.registry import KernelMapper, get_kernel, register_kernel
from tpumr_torch.ops import kmeans  # noqa: F401  (registers kmeans-assign)
from tpumr_torch.ops import matmul  # noqa: F401  (registers matmul-block)

__all__ = ["KernelMapper", "get_kernel", "register_kernel"]
