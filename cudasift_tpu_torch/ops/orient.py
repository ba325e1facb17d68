"""Orientation assignment (ComputeOrientationsCONST, cudaSiftD.cu:972-1057).

``compute_orientations`` is the plain version of phases 2-3 of the fused
orientation+descriptor kernel (``ops/cuda/orient_desc.py``), and with the
split geometry ``texture.SPLIT_ORIENT`` ``keypoint_histograms`` is the plain
version of the orientation-histogram kernel (``ops/cuda/orient.py``):
``orientation_histograms`` samples a 13x13 grid of image values bilinearly
shifted by the keypoint's subpixel fraction, takes central differences over
its inner 11x11 window, weights them with a Gaussian of sigma = 1.5*scale
and bins them into 32 orientations; ``histogram_peaks`` smooths the
histogram and finds the two orientations.
"""

from __future__ import annotations

import torch

from .texture import FUSED, Geometry, atan2_poly, keypoint_patches

NUM_BINS = 32


def orientation_histograms(read, fx, fy, cbase, rbase, scale,
                           grid_max: tuple[int, int] = (31, 31)) -> torch.Tensor:
    """(N, 32) gradient-orientation histograms.

    ``read`` is a ``texture.Patches.read``; ``fx``/``fy`` (N,) are the
    keypoint's subpixel fractions, ``cbase``/``rbase`` (N,) int64 the patch
    column/row of grid entry 0 (``floor(x) - origin - 6``). Grid entry
    ``(uy, ux)`` holds the patch bilinearly sampled at
    ``(rbase + uy + fy, cbase + ux + fx)``, with the integer index clamped
    to [0, grid_max] and the fraction kept (the kernels' border rule).
    """
    n = fx.shape[0]
    dev = fx.device
    u = torch.arange(13, device=dev)
    rows = torch.clamp(rbase[:, None] + u, 0, grid_max[0])[:, :, None]   # (N, 13, 1)
    cols = torch.clamp(cbase[:, None] + u, 0, grid_max[1])[:, None, :]   # (N, 1, 13)
    fxv = fx[:, None, None]
    fyv = fy[:, None, None]
    v = (1.0 - fyv) * ((1.0 - fxv) * read(rows, cols) + fxv * read(rows, cols + 1)) \
        + fyv * ((1.0 - fxv) * read(rows + 1, cols) + fxv * read(rows + 1, cols + 1))
    dx = v[:, 1:12, 2:13] - v[:, 1:12, 0:11]                    # (N, 11, 11)
    dy = v[:, 2:13, 1:12] - v[:, 0:11, 1:12]
    theta = atan2_poly(dy, dx)
    bins = torch.floor(16.0 * theta / 3.1416 + 16.5).to(torch.int64)
    bins = torch.where(bins > 31, 0, bins)
    d = torch.arange(11, device=dev, dtype=torch.float32) - 5.0
    dist2 = d[None, :] * d[None, :] + d[:, None] * d[:, None]   # (uy, ux)
    i2s2 = -1.0 / (2.0 * 1.5 * 1.5 * scale * scale)
    wgt = torch.sqrt(dx * dx + dy * dy) * torch.exp(i2s2[:, None, None] * dist2)
    onehot = bins.reshape(n, 121, 1) == torch.arange(NUM_BINS, device=dev)
    return torch.where(onehot, wgt.reshape(n, 121, 1), 0.0).sum(dim=1)


def histogram_peaks(hist: torch.Tensor):
    """Smooth, find the top two local peaks, parabola-refine to degrees.

    Returns (primary_deg (N,), secondary_deg (N,), has_second (N,) bool).
    Circular [1,4,6,4,1] smoothing (cudaSiftD.cu:1009); a bin is a peak if
    strictly above its left neighbour and >= its right one
    (cudaSiftD.cu:1014); ties go to the lowest bin.
    """
    sm = (
        6.0 * hist
        + 4.0 * (torch.roll(hist, 1, dims=1) + torch.roll(hist, -1, dims=1))
        + torch.roll(hist, 2, dims=1)
        + torch.roll(hist, -2, dims=1)
    )
    peaks = torch.where(
        (sm > torch.roll(sm, 1, dims=1)) & (sm >= torch.roll(sm, -1, dims=1)),
        sm, 0.0)
    max1 = peaks.max(dim=1).values
    i1 = torch.argmax(peaks, dim=1)
    cols = torch.arange(peaks.shape[1], device=hist.device)
    masked = torch.where(cols[None, :] == i1[:, None], -torch.inf, peaks)
    max2 = masked.max(dim=1).values
    i2 = torch.argmax(masked, dim=1)

    def interp(i, m):
        v1 = torch.gather(sm, 1, ((i + 1) % 32)[:, None])[:, 0]
        v2 = torch.gather(sm, 1, ((i - 1) % 32)[:, None])[:, 0]
        denom = 2.0 * m - v1 - v2
        peak = i.to(torch.float32) + 0.5 * (v1 - v2) / torch.where(
            denom == 0.0, 1e-30, denom)
        return 11.25 * torch.where(peak < 0.0, peak + 32.0, peak)

    return interp(i1, max1), interp(i2, max2), max2 > 0.8 * max1


def keypoint_histograms(img: torch.Tensor, xpos: torch.Tensor, ypos: torch.Tensor,
                        scale: torch.Tensor, geom: Geometry = FUSED) -> torch.Tensor:
    """(N, 32) orientation histograms of (N,) keypoints, with the patch
    geometry ``geom`` (``texture.keypoint_patches``)."""
    p = keypoint_patches(img, xpos, ypos, scale, geom)
    flx = torch.floor(p.x)
    fly = torch.floor(p.y)
    return orientation_histograms(
        p.read, p.x - flx, p.y - fly, flx.to(torch.int64) - p.ox - 6,
        fly.to(torch.int64) - p.oy - 6, scale, geom.grid_max)


def compute_orientations(img: torch.Tensor, xpos: torch.Tensor,
                         ypos: torch.Tensor, scale: torch.Tensor):
    """(primary_deg, secondary_deg, has_second) for (N,) keypoints, with the
    fused kernel's patch geometry."""
    return histogram_peaks(keypoint_histograms(img, xpos, ypos, scale))
