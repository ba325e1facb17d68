"""K7 wrapper: exact descriptors of front-packed oriented keypoints.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/descriptor.py``
(``extract_descriptors_pallas``), the second half of the split
orientation/descriptor path (``SiftParams(use_fused=False)``). The CUDA
kernel (``csrc/descriptor.cu``) is bound by per-keypoint latency: one
256-thread block per slot takes the four rotated bilinear gradient taps of
its 16x16 grid straight from the image through the cache, then bins and
normalises in shared memory with sums in a fixed order (no float atomics,
so two runs are bit-identical). It runs in float32 throughout (the TPU
kernel's bfloat16 MXU sampling is its precision artefact). Slots at or past
the on-device ``count`` come back zero without a host read of the count.
Its plain version is ``extract_descriptors_plain`` below, which CPU tensors
take.

Geometry is the TPU kernel's (``texture.SPLIT_DESC``): a 48x128 patch from
the origin ``max(floor(.) - 22, 0)``, edge-padded past the bottom/right
border, each tap's coordinates clipped to the patch, and positions not
clamped into the image first.
"""

from __future__ import annotations

import ctypes

import torch

from .. import descriptor, texture
from ...utils.build import Kernel, check, count_tensor, ptr

KERNEL = Kernel(
    "descriptor.cu", "extract_descriptors",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    flags=("-fmad=false",),
    replaces="cudasift_tpu/ops/pallas/descriptor.py:241",
)


def extract_descriptors_plain(img, xpos, ypos, scale, orientation, count) -> torch.Tensor:
    """Plain PyTorch version of ``extract_descriptors`` (any device)."""
    desc = descriptor.extract_descriptors(img, xpos, ypos, scale, orientation,
                                          "exact", texture.SPLIT_DESC)
    live = torch.arange(xpos.shape[0], device=img.device) < count
    return torch.where(live[:, None], desc, 0.0)


def extract_descriptors(img: torch.Tensor, xpos: torch.Tensor, ypos: torch.Tensor,
                        scale: torch.Tensor, orientation: torch.Tensor,
                        count) -> torch.Tensor:
    """(N, 128) unit descriptors of the first ``count`` slots; the rest are
    zero.

    ``img`` (H, W) f32 octave base; ``xpos``/``ypos``/``scale`` (N,) f32 in
    octave coordinates and ``orientation`` (N,) f32 in degrees, live
    keypoints front-packed; ``count`` an int or a 0-d int32 tensor.
    """
    if img.device.type == "cpu":
        return extract_descriptors_plain(img, xpos, ypos, scale, orientation, count)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    h, w = img.shape
    n = xpos.shape[0]
    dev = img.device
    check(img, "img", torch.float32, (h, w), dev)
    for name, t in (("xpos", xpos), ("ypos", ypos), ("scale", scale),
                    ("orientation", orientation)):
        check(t, name, torch.float32, (n,), dev)
    count = count_tensor(count, "count", dev)
    desc = torch.empty((n, 128), dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(img), h, w, ptr(xpos), ptr(ypos), ptr(scale), ptr(orientation),
           ptr(count), n, ptr(desc))
    return desc
