"""Hand-written CUDA kernels of the main path and their wrappers.

Each wrapper launches its kernel on CUDA tensors and takes the kernel's
plain PyTorch version on CPU tensors; any other device raises.
"""

from . import dog, match, orient_desc, refine

# The main path's kernels, in pipeline order.
KERNELS = (dog.KERNEL, refine.KERNEL, orient_desc.KERNEL, match.KERNEL)
