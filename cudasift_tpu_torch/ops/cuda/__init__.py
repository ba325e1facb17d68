"""Hand-written CUDA kernels and their wrappers.

Each wrapper launches its kernel on CUDA tensors and takes the kernel's
plain PyTorch version on CPU tensors; any other device raises.
"""

from . import (acquire, compact, descriptor, dog, lstsq, match, orient, orient_desc,
               probes, ransac, refine, scale_up)

# The library kernels, K1-K8.
LIBRARY = (dog.KERNEL, refine.KERNEL, orient_desc.KERNEL, match.KERNEL,
           match.SWEEP_KERNEL, orient.KERNEL, descriptor.KERNEL, compact.KERNEL)
# Every port of a TPU kernel: K1-K8, the four patch-acquisition launchers
# (P1) and the eight capability probes (P2).
KERNELS = LIBRARY + tuple(acquire.KERNELS.values()) + probes.KERNELS
# The kernels of the homography programs, which stand beside the XLA code of
# the JAX package and replace no TPU kernel: RANSAC's scoring and the
# weighted refit of its LO passes.
HOMOGRAPHY = (ransac.SCORE_KERNEL, lstsq.KERNEL)
# The upsample that starts an extraction with SiftParams(scale_up=True),
# which stands beside the XLA code of the JAX package and replaces no TPU
# kernel.
UPSCALE = (scale_up.KERNEL,)
# The kernels each extraction flow launches, in pipeline order, with the
# matcher: the fused path (the default, SiftParams(use_fused=True)) and the
# split path (SiftParams(use_fused=False, use_pallas_compact=True)).
FUSED_PATH = (dog.KERNEL, refine.KERNEL, orient_desc.KERNEL, match.KERNEL)
SPLIT_PATH = (dog.KERNEL, compact.KERNEL, refine.KERNEL, orient.KERNEL,
              descriptor.KERNEL, match.KERNEL)
