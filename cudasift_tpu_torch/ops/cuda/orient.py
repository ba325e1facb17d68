"""K6 wrapper: orientation histograms of front-packed keypoints and their
two peaks.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/orient.py``
(``orientation_histograms_pallas``), the first half of the split
orientation/descriptor path (``SiftParams(use_fused=False)``), together with
the peak search that follows it there (``histogram_peaks``, which the JAX
package leaves to XLA inside the same compiled program). The CUDA kernel
(``csrc/orient.cu``) gives a warp to each slot: the 16 x 16 corner of the
keypoint's patch that the 13x13 grid touches is staged once in shared
memory, each lane adds its four samples into its own column of a (bins x
lanes) table there and lane b then adds up row b, in a fixed order (no float
atomics, so two runs are bit-identical), and the same warp then searches the two peaks with a bin a lane, so that ``orientation_peaks``
needs one launch and the histograms never come back for a second pass.
Slots at or past the on-device ``count`` come back zero (``has_second``
False) without a host read of the count. The plain versions below are what
CPU tensors take.

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
    "orient.cu", "orientation_peaks",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p],
    flags=("-fmad=false",),
    replaces="cudasift_tpu/ops/pallas/orient.py:227",
)


def orientation_histograms_plain(img, xpos, ypos, scale, count) -> torch.Tensor:
    """Plain PyTorch version of ``orientation_histograms`` (any device)."""
    hist = orient.keypoint_histograms(img, xpos, ypos, scale, texture.SPLIT_ORIENT)
    live = torch.arange(xpos.shape[0], device=img.device) < count
    return torch.where(live[:, None], hist, 0.0)


def orientation_peaks_plain(img, xpos, ypos, scale, count):
    """Plain PyTorch version of ``orientation_peaks`` (any device):
    ``orientation_histograms_plain`` followed by ``histogram_peaks``, the
    peaks of slots at or past ``count`` zeroed."""
    hist = orientation_histograms_plain(img, xpos, ypos, scale, count)
    primary, secondary, has_second = orient.histogram_peaks(hist)
    live = torch.arange(xpos.shape[0], device=img.device) < count
    return (hist, torch.where(live, primary, 0.0), torch.where(live, secondary, 0.0),
            live & has_second)


def _launch(img, xpos, ypos, scale, count, peaks: bool):
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
    out = [hist]
    if peaks:
        out += [torch.empty((n,), dtype=torch.float32, device=dev) for _ in range(2)]
        out.append(torch.empty((n,), dtype=torch.bool, device=dev))
    # Without the peaks the kernel gets null pointers and skips the search.
    KERNEL(dev, ptr(img), h, w, ptr(xpos), ptr(ypos), ptr(scale), ptr(count), n,
           *(ptr(t) for t in out), *([None] * (4 - len(out))))
    return out


def orientation_histograms(img: torch.Tensor, xpos: torch.Tensor, ypos: torch.Tensor,
                           scale: torch.Tensor, count) -> torch.Tensor:
    """(N, 32) orientation histograms of the first ``count`` slots; the rest
    are zero.

    ``img`` (H, W) f32 octave base; ``xpos``/``ypos``/``scale`` (N,) f32 in
    octave coordinates, live keypoints front-packed; ``count`` an int or a
    0-d int32 tensor. ``orientation_peaks`` gives the peaks with them.
    """
    if img.device.type == "cpu":
        return orientation_histograms_plain(img, xpos, ypos, scale, count)
    return _launch(img, xpos, ypos, scale, count, peaks=False)[0]


def orientation_peaks(img: torch.Tensor, xpos: torch.Tensor, ypos: torch.Tensor,
                      scale: torch.Tensor, count):
    """(histograms (N, 32), primary_deg (N,), secondary_deg (N,), has_second
    (N,) bool) of the first ``count`` slots from one launch; the rest are
    zero and False. Arguments as ``orientation_histograms``; the peaks are
    ``ops.orient.histogram_peaks`` of the histograms."""
    if img.device.type == "cpu":
        return orientation_peaks_plain(img, xpos, ypos, scale, count)
    return tuple(_launch(img, xpos, ypos, scale, count, peaks=True))
