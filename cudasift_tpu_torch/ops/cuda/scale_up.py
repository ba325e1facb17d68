"""ScaleUp: the 2x upsample that starts an extraction with
``SiftParams(scale_up=True)``, as one hand-written kernel.

Replaces no TPU kernel: the JAX package upsamples with XLA code
(``cudasift_tpu/ops/convolve.py``, ``scale_up``), which has no Pallas
kernel. The CUDA kernel (``csrc/scale_up.cu``) reads each input pixel's
2x2 neighbourhood and writes its 2x2 output block, two pixels a thread with
16-byte stores, so a frame costs one launch and about the least traffic
(the input read once, the output written once) where the plain version runs
some fourteen kernels. It keeps the plain version's sums in their order, so
the two are equal bit for bit. The plain version is ``convolve.scale_up``,
which CPU tensors take.
"""

from __future__ import annotations

import ctypes

import torch

from .. import convolve
from ...utils.build import Kernel, check, ptr

KERNEL = Kernel(
    "scale_up.cu", "scale_up",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    flags=("-fmad=false",),
    replaces="cudasift_tpu/ops/convolve.py:117",
)

# Input rows the kernel's grid can cover (65535 blocks of 4 rows).
MAX_HEIGHT = 65535 * 4


def scale_up(img: torch.Tensor) -> torch.Tensor:
    """(2H, 2W) float32: ``img`` (H, W) float32 upsampled 2x, top-left
    aligned, with its right and down neighbours clamped at the edge."""
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return convolve.scale_up(img)
    h, w = img.shape
    check(img, "img", torch.float32, (h, w), img.device)
    if h > MAX_HEIGHT:
        raise ValueError(f"{h} rows are past the kernel's grid ({MAX_HEIGHT})")
    out = torch.empty((2 * h, 2 * w), dtype=torch.float32, device=img.device)
    KERNEL(img.device, ptr(img), h, w, ptr(out))
    return out
