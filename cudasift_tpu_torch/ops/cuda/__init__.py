"""Hand-written CUDA kernels and their wrappers.

Each wrapper launches its kernel on CUDA tensors and takes the kernel's
plain PyTorch version on CPU tensors; any other device raises.
"""

from . import compact, descriptor, dog, match, orient, orient_desc, refine

# Every kernel, K1-K8.
KERNELS = (dog.KERNEL, refine.KERNEL, orient_desc.KERNEL, match.KERNEL,
           match.SWEEP_KERNEL, orient.KERNEL, descriptor.KERNEL, compact.KERNEL)
# The kernels each extraction flow launches, in pipeline order, with the
# matcher: the fused path (the default, SiftParams(use_fused=True)) and the
# split path (SiftParams(use_fused=False, use_pallas_compact=True)).
FUSED_PATH = (dog.KERNEL, refine.KERNEL, orient_desc.KERNEL, match.KERNEL)
SPLIT_PATH = (dog.KERNEL, compact.KERNEL, refine.KERNEL, orient.KERNEL,
              descriptor.KERNEL, match.KERNEL)
