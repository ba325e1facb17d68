"""K3 wrapper: fused orientation + descriptors for every live keypoint slot.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/orient_desc.py``
(``orient_and_describe_pallas``). The CUDA kernel (``csrc/orient_desc.cu``)
is bound by per-keypoint latency: one 256-thread block per slot stages the
keypoint's patch in shared memory and runs all five phases from there, so
the image is read once per keypoint and no intermediate leaves the chip.
Sums run in a fixed order (no float atomics), so results are
deterministic. It takes the validity mask directly: no compaction runs
before it. Its plain version is ``orient_and_describe_plain`` below,
built from ``ops.orient.compute_orientations`` and
``ops.descriptor.extract_descriptors``; CPU tensors take it.

Patch geometry, border clamps and sampler arithmetic are those of the TPU
kernel: scale <= 1.72 uses a (32, 32) patch with margin 15, larger scales
(48, 64) with margin 22; the patch origin is ``max(floor(y) - margin, 0)``
with edge padding past the bottom/right border; sampling coordinates are
clamped into the image box first.
"""

from __future__ import annotations

import ctypes

import torch

from .. import descriptor, orient
from ...utils.build import Kernel, check, ptr

# Descriptor samplers, by the kernel's mode argument.
MODES = ("exact", "shift", "fast")

KERNEL = Kernel(
    "orient_desc.cu", "orient_and_describe",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p],
    flags=("-fmad=false",),
    replaces="cudasift_tpu/ops/pallas/orient_desc.py:764",
)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def orient_and_describe_plain(img, xpos, ypos, scale, live, mode: str = "shift"):
    """Plain PyTorch version of ``orient_and_describe`` (any device)."""
    _check_mode(mode)
    ori1, ori2, has2 = orient.compute_orientations(img, xpos, ypos, scale)
    desc1 = descriptor.extract_descriptors(img, xpos, ypos, scale, ori1, mode)
    desc2 = descriptor.extract_descriptors(img, xpos, ypos, scale, ori2, mode)
    has2 = has2 & live
    z = torch.zeros((), dtype=torch.float32, device=img.device)
    return (torch.where(live[:, None], desc1, z),
            torch.where(has2[:, None], desc2, z),
            torch.where(live, ori1, z),
            torch.where(live, ori2, z),
            has2)


def orient_and_describe(img: torch.Tensor, xpos: torch.Tensor, ypos: torch.Tensor,
                        scale: torch.Tensor, live: torch.Tensor, mode: str = "shift"):
    """Orientations and descriptors for the slots where ``live`` is set.

    ``img`` (H, W) f32 octave base; ``xpos``/``ypos``/``scale`` (N,) f32 in
    octave coordinates; ``live`` (N,) bool. Returns (desc1 (N, 128),
    desc2 (N, 128), ori1 (N,), ori2 (N,), has2 (N,) bool): descriptors of
    the primary and second histogram peaks (orientations in degrees);
    ``desc2`` is zero where ``has2`` is not set. Dead slots are zero.
    """
    _check_mode(mode)
    if img.device.type == "cpu":
        return orient_and_describe_plain(img, xpos, ypos, scale, live, mode)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    h, w = img.shape
    n = xpos.shape[0]
    dev = img.device
    check(img, "img", torch.float32, (h, w), dev)
    for name, t in (("xpos", xpos), ("ypos", ypos), ("scale", scale)):
        check(t, name, torch.float32, (n,), dev)
    check(live, "live", torch.bool, (n,), dev)
    desc1 = torch.empty((n, 128), dtype=torch.float32, device=dev)
    desc2 = torch.empty((n, 128), dtype=torch.float32, device=dev)
    ori1 = torch.empty((n,), dtype=torch.float32, device=dev)
    ori2 = torch.empty((n,), dtype=torch.float32, device=dev)
    has2 = torch.empty((n,), dtype=torch.bool, device=dev)
    KERNEL(dev, ptr(img), h, w, ptr(xpos), ptr(ypos), ptr(scale), ptr(live), n,
           MODES.index(mode), ptr(desc1), ptr(desc2), ptr(ori1),
           ptr(ori2), ptr(has2))
    return desc1, desc2, ori1, ori2, has2
