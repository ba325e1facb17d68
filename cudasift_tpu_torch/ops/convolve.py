"""Separable Gaussian convolutions and resampling, clamp-to-edge.

- ``low_pass``   -- 9-tap Gaussian prefilter (cudaSiftH.cu:406-435)
- ``scale_down`` -- 5-tap Gaussian blur + 2x decimation (cudaSiftD.cu:84-168)
- ``scale_up``   -- 2x top-left-aligned bilinear upsample (cudaSiftD.cu:170-190)
- ``blur_multi`` -- the 8 Gaussian scales of one octave (the blur half of
  LaplaceMultiMem, cudaSiftD.cu:1753-1793); the plain version of the blur
  inside the DoG kernel (``ops/cuda/dog.py``)

Every pass is an unrolled sum of shifted slices of an edge-replicated
array: vertical first, then horizontal, taps 0..8 in order, each product
rounded before it is added. The DoG kernel uses the same order, so the two
agree bit for bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import gaussian_kernel_1d


def _edge_rows(img: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """``img`` with ``r`` edge-replicated entries added on both ends of
    ``dim`` (clamp-to-edge addressing)."""
    n = img.shape[dim]
    idx = torch.arange(-r, n + r, device=img.device).clamp_(0, n - 1)
    return img.index_select(dim, idx)


def sep_conv_clamp(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable symmetric convolution with clamp-to-edge, vertical then
    horizontal, same output shape. ``taps`` is a numpy vector."""
    r = (len(taps) - 1) // 2
    h, w = img.shape
    pv = _edge_rows(img, r, 0)
    tmp = float(taps[0]) * pv[0:h]
    for j in range(1, 2 * r + 1):
        tmp = tmp + float(taps[j]) * pv[j:j + h]
    ph = _edge_rows(tmp, r, 1)
    out = float(taps[0]) * ph[:, 0:w]
    for j in range(1, 2 * r + 1):
        out = out + float(taps[j]) * ph[:, j:j + w]
    return out


def low_pass(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """9-tap Gaussian prefilter at sigma = max(initBlur, 0.001)
    (cudaSiftH.cu:112,406-421)."""
    taps = gaussian_kernel_1d(4, float(sigma) * float(sigma))
    return sep_conv_clamp(img, taps)


def scale_down(img: torch.Tensor, variance: float = 0.5) -> torch.Tensor:
    """5-tap Gaussian blur + 2x decimation (cudaSiftD.cu:84-168):
    ``out[y, x] = sum_ij k[i] k[j] img[clamp(2y+j-2), clamp(2x+i-2)]``,
    computed as a direct stride-2 sum of taps."""
    taps = gaussian_kernel_1d(2, float(variance))
    h, w = img.shape
    oh, ow = h // 2, w // 2
    pv = _edge_rows(img, 2, 0)
    tmp = float(taps[0]) * pv[0:2 * oh:2]
    for j in range(1, 5):
        tmp = tmp + float(taps[j]) * pv[j:j + 2 * oh:2]
    ph = _edge_rows(tmp, 2, 1)
    out = float(taps[0]) * ph[:, 0:2 * ow:2]
    for j in range(1, 5):
        out = out + float(taps[j]) * ph[:, j:j + 2 * ow:2]
    return out


def scale_up(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample, top-left aligned (cudaSiftD.cu:170-190):
    ``out[2y, 2x] = in[y, x]``; right/down neighbours averaged with edge
    clamping."""
    h, w = img.shape
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    down = torch.cat([img[1:, :], img[-1:, :]], dim=0)
    down_right = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    top = torch.stack([img, 0.5 * (img + right)], dim=2).reshape(h, 2 * w)
    bot = torch.stack(
        [0.5 * (img + down), 0.25 * (img + right + down + down_right)], dim=2
    ).reshape(h, 2 * w)
    return torch.stack([top, bot], dim=1).reshape(2 * h, 2 * w)


def blur_multi(img: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """All 8 Gaussian scales of one octave: (H, W) -> (8, H, W).

    ``kernels`` is the (8, 9) tap table of the octave (PrepareLaplaceKernels,
    cudaSiftH.cu:439-458).
    """
    r = 4
    h, w = img.shape
    k = torch.as_tensor(np.asarray(kernels, np.float32), device=img.device)
    kv = k[:, :, None, None]                                # (8, 9, 1, 1)
    pv = _edge_rows(img, r, 0)
    vert = kv[:, 0] * pv[None, 0:h]
    for j in range(1, 2 * r + 1):
        vert = vert + kv[:, j] * pv[None, j:j + h]
    ph = _edge_rows(vert, r, 2)
    acc = kv[:, 0] * ph[:, :, 0:w]
    for j in range(1, 2 * r + 1):
        acc = acc + kv[:, j] * ph[:, :, j:j + w]
    return acc
