"""K1 wrapper: blur + DoG + extrema mask for one octave base.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/dog.py``
(``dog_and_mask_pallas``). The CUDA kernel (``csrc/dog.cu``) stages each
32x64 tile with its clamped halo in shared memory once and derives all 8
blurs, 7 DoG planes and the mask from there: register-blocked separable
passes with the taps in the constant bank, the DoG taken in registers, a
separable 3x3x3 extremum test over two shared DoG planes, one barrier per
scale. It must move 37 bytes a pixel; the blurs' unfused float
instructions set its pace. It equals its plain version,
``convolve.blur_multi`` followed by ``detect.extrema_mask``, bit for bit;
CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import convolve, detect
from ...utils.build import Kernel, check, ptr

KERNEL = Kernel(
    "dog.cu", "dog_and_mask",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p],
    flags=("-fmad=false",),
    replaces="cudasift_tpu/ops/pallas/dog.py:263",
)


def dog_and_mask_plain(img: torch.Tensor, kernels: np.ndarray, thresh: float,
                       edge_limit: float = 10.0):
    """Plain PyTorch version of ``dog_and_mask`` (any device)."""
    blur = convolve.blur_multi(img, kernels)
    dog = blur[1:] - blur[:-1]
    return dog, detect.extrema_mask(dog, thresh, edge_limit)


def dog_and_mask(img: torch.Tensor, kernels: np.ndarray, thresh: float,
                 edge_limit: float = 10.0):
    """(dog (7, H, W) f32, mask (5, H, W) bool) for one octave base.

    ``kernels`` is the octave's (8, 9) tap table. The mask holds strict
    3x3x3 extrema of DoG planes 1-5 beyond ``thresh`` that pass the edge
    test, interior pixels only.
    """
    if img.device.type == "cpu":
        return dog_and_mask_plain(img, kernels, thresh, edge_limit)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    h, w = img.shape
    check(img, "img", torch.float32, (h, w), img.device)
    taps = np.ascontiguousarray(kernels, dtype=np.float32)
    if taps.shape != (8, 9):
        raise ValueError(f"expected (8, 9) taps, got {taps.shape}")
    dog = torch.empty((7, h, w), dtype=torch.float32, device=img.device)
    mask = torch.empty((5, h, w), dtype=torch.bool, device=img.device)
    KERNEL(img.device, ptr(img), taps.ctypes.data_as(ctypes.c_void_p), h, w,
           float(thresh), float(edge_limit), ptr(dog), ptr(mask))
    return dog, mask
