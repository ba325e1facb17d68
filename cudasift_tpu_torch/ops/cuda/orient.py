"""K6 wrapper: orientation histograms of front-packed keypoints.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/orient.py``
(``orientation_histograms_pallas``), the first half of the split
orientation/descriptor path (``SiftParams(use_fused=False)``). The CUDA
kernel (``csrc/orient.cu``) is bound by the latency of scattered reads: one
warp per slot samples the keypoint's 13x13 grid straight from the image
through the cache and sums each of the 32 bins in a fixed order (no float
atomics, so two runs are bit-identical). Slots at or past the on-device
``count`` come back zero without a host read of the count. Its plain
version is ``orientation_histograms_plain`` below, which CPU tensors take.

Geometry is the TPU kernel's (``texture.SPLIT_ORIENT``): a 16x128 patch
from the origin ``max(floor(.) - 7, 0)``, edge-padded past the bottom/right
border, the grid's integer index clamped into the patch with the subpixel
fraction kept, and positions not clamped into the image first.
"""

from __future__ import annotations

import ctypes

import torch

from .. import orient, texture
from ...utils.build import Kernel, check, count_tensor, ptr

KERNEL = Kernel(
    "orient.cu", "orientation_histograms",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    flags=("-fmad=false",),
    replaces="cudasift_tpu/ops/pallas/orient.py:227",
)


def orientation_histograms_plain(img, xpos, ypos, scale, count) -> torch.Tensor:
    """Plain PyTorch version of ``orientation_histograms`` (any device)."""
    hist = orient.keypoint_histograms(img, xpos, ypos, scale, texture.SPLIT_ORIENT)
    live = torch.arange(xpos.shape[0], device=img.device) < count
    return torch.where(live[:, None], hist, 0.0)


def orientation_histograms(img: torch.Tensor, xpos: torch.Tensor, ypos: torch.Tensor,
                           scale: torch.Tensor, count) -> torch.Tensor:
    """(N, 32) orientation histograms of the first ``count`` slots; the rest
    are zero.

    ``img`` (H, W) f32 octave base; ``xpos``/``ypos``/``scale`` (N,) f32 in
    octave coordinates, live keypoints front-packed; ``count`` an int or a
    0-d int32 tensor. Peaks: ``ops.orient.histogram_peaks``.
    """
    if img.device.type == "cpu":
        return orientation_histograms_plain(img, xpos, ypos, scale, count)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    h, w = img.shape
    n = xpos.shape[0]
    dev = img.device
    check(img, "img", torch.float32, (h, w), dev)
    for name, t in (("xpos", xpos), ("ypos", ypos), ("scale", scale)):
        check(t, name, torch.float32, (n,), dev)
    count = count_tensor(count, "count", dev)
    hist = torch.empty((n, 32), dtype=torch.float32, device=dev)
    KERNEL(dev, ptr(img), h, w, ptr(xpos), ptr(ypos), ptr(scale), ptr(count), n, ptr(hist))
    return hist
