"""Kernel mappers. Importing the package registers every built-in kernel."""

from tpumr_torch.ops.registry import (KernelMapper, get_kernel, kernels,
                                      register_kernel)
from tpumr_torch.ops import grep  # noqa: F401  (registers grep)
from tpumr_torch.ops import kmeans  # noqa: F401  (registers kmeans-assign)
from tpumr_torch.ops import matmul  # noqa: F401  (registers matmul-block)
from tpumr_torch.ops import pi  # noqa: F401  (registers pi-sampler)
from tpumr_torch.ops import wordcount  # noqa: F401  (registers wordcount)

__all__ = ["KernelMapper", "get_kernel", "kernels", "register_kernel"]
