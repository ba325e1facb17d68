"""Bilinear texture sampling and the two atan2 polynomials.

``tex2d`` reproduces CUDA's unnormalized ``tex2D`` with linear filtering
and clamp addressing (cudaSiftH.cu:187-205) in full float precision: the
texel centred at integer pixel (i, j) is sampled at (i+0.5, j+0.5).
``fast_atan2`` is the reference's FastAtan2 (cudaSiftD.cu:295-306), used
for descriptor angles; ``atan2_poly`` is the octant-reduced minimax atan2
the orientation histogram uses for its bins.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def tex2d(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (H, W) at float coordinate tensors ``x``, ``y`` (same
    shape) in CUDA's unnormalized texture convention."""
    h, w = img.shape
    xb = torch.clamp(x - 0.5, 0.0, w - 1.0)
    yb = torch.clamp(y - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(xb)
    y0 = torch.floor(yb)
    ax = xb - x0
    ay = yb - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    top = v00 + ax * (v01 - v00)
    bot = v10 + ax * (v11 - v10)
    return top + ay * (bot - top)


# Patch geometries of the fused orientation+descriptor kernel:
# (rows, cols, margin). Octave-local scales <= SMALL_MAX_SCALE use the small
# patch; margin >= 7.96*scale + 2.5 keeps every descriptor tap inside it.
GEOM_SMALL = (32, 32, 15)
GEOM_LARGE = (48, 64, 22)
SMALL_MAX_SCALE = 1.72


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Where a kernel reads a keypoint's patch, and how it clamps.

    ``small``/``large`` are (rows, cols, margin) for scales at or below /
    above ``small_max_scale``; the patch origin is ``max(floor(.) - margin,
    0)``. ``clamp_to_image`` clamps the sampling position into the image box
    first. ``grid_max`` (rows, cols) bounds the orientation grid's integer
    index, whose subpixel fraction is kept.
    """

    small: tuple[int, int, int]
    large: tuple[int, int, int]
    small_max_scale: float
    clamp_to_image: bool
    grid_max: tuple[int, int]


# The fused orientation+descriptor kernel (K3).
FUSED = Geometry(GEOM_SMALL, GEOM_LARGE, SMALL_MAX_SCALE, True, (31, 31))
# The split kernels: one patch for every scale, positions not clamped.
# Orientation histograms (K6) read a 16x128 patch with margin 7;
# descriptors (K7) a 48x128 patch with margin 22.
SPLIT_ORIENT = Geometry((16, 128, 7), (16, 128, 7), float("inf"), False, (15, 127))
SPLIT_DESC = Geometry((48, 128, 22), (48, 128, 22), float("inf"), False, (47, 127))


@dataclasses.dataclass
class Patches:
    """Per-keypoint patches of a kernel's ``Geometry``.

    ``x``/``y`` are the keypoint sampling positions (clamped into the image
    box where the geometry says so), ``ox``/``oy`` the (N,) int64 patch
    origins ``max(floor(.) - margin, 0)``, ``rows``/``cols`` the (N,) patch
    sizes. ``read(r, c)`` takes integer tensors of shape (N, ...) and returns
    ``img[min(oy + r, H-1), min(ox + c, W-1)]`` per keypoint: the patch,
    edge-padded past the bottom and right image borders.
    """

    read: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    x: torch.Tensor
    y: torch.Tensor
    ox: torch.Tensor
    oy: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor


def keypoint_patches(img: torch.Tensor, xpos: torch.Tensor, ypos: torch.Tensor,
                     scale: torch.Tensor, geom: Geometry = FUSED) -> Patches:
    """The patches of (N,) keypoints of ``img`` in geometry ``geom``.
    Reported positions are never touched."""
    h, w = img.shape
    if geom.clamp_to_image:
        x = torch.clamp(xpos, 0.0, float(w - 1))
        y = torch.clamp(ypos, 0.0, float(h - 1))
    else:
        x, y = xpos, ypos
    small = scale <= geom.small_max_scale
    rows, cols, margin = (torch.where(small, a, b) for a, b in zip(geom.small, geom.large))
    ox = torch.clamp(torch.floor(x).to(torch.int64) - margin, min=0)
    oy = torch.clamp(torch.floor(y).to(torch.int64) - margin, min=0)
    flat = img.reshape(-1)

    def read(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (max(r.dim(), c.dim()) - 1)
        rr = torch.clamp(oy.reshape(shape) + r, 0, h - 1)
        cc = torch.clamp(ox.reshape(shape) + c, 0, w - 1)
        return flat[rr * w + cc]

    return Patches(read=read, x=x, y=y, ox=ox, oy=oy, rows=rows, cols=cols)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2 (FastAtan2, cudaSiftD.cu:295-306), max error about
    0.005 rad."""
    absx = x.abs()
    absy = y.abs()
    mx = torch.maximum(absx, absy)
    mn = torch.minimum(absx, absy)
    a = mn / torch.where(mx == 0.0, 1.0, mx)
    s = a * a
    r = ((-0.0464964749 * s + 0.15931422) * s - 0.327622764) * s * a + a
    r = torch.where(absy > absx, 1.57079637 - r, r)
    r = torch.where(x < 0, 3.14159274 - r, r)
    return torch.where(y < 0, -r, r)


# atan(z) on [0, 1] as a degree-15 odd polynomial, highest power first.
ATAN_POLY = (-0.0040540580, 0.0218612288, -0.0559098861, 0.0964200441,
             -0.1390853351, 0.1994653599, -0.3332985605, 0.9999993329)


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Octant-reduced minimax atan2, |err| < 1e-6 rad."""
    absx = x.abs()
    absy = y.abs()
    mx = torch.maximum(absx, absy)
    mn = torch.minimum(absx, absy)
    z = mn / torch.where(mx == 0.0, 1.0, mx)
    s = z * z
    r = torch.full_like(z, ATAN_POLY[0])
    for c in ATAN_POLY[1:]:
        r = r * s + c
    r = r * z
    r = torch.where(absy > absx, 1.5707963268 - r, r)
    r = torch.where(x < 0, 3.1415926536 - r, r)
    return torch.where(y < 0, -r, r)
