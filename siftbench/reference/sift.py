"""The plain reference of SIFT extraction, in plain PyTorch.

A frozen copy of the plain PyTorch stages of the measured program's fused
extraction path (CudaSift's ExtractSift, cudaSiftH.cu:72-232), kept here so
that a change to the program cannot move what it is judged against. It runs
on any device, reads only the frame and the configuration, and imports
nothing of the program:

1. the 9-tap prefilter and the 5-tap decimations of the pyramid;
2. per octave, smallest first: the 8 Gaussian scales, 7 DoG planes and the
   strict 3x3x3 extremum mask with the edge test; raster-order compaction
   into the octave's candidate capacity; subpixel refinement; orientation
   (32-bin histogram, two peaks) and the 128-D descriptors of each peak with
   the ``shift`` gradient sampler;
3. one stable compaction of every octave's slots into ``max_pts``.

``Precision`` selects float32 (the reference) or TF32 (the control).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .precision import FLOAT32, Precision

NUM_SCALES = 5
NUM_LAPLACE_SCALES = NUM_SCALES + 3
LAPLACE_R = 4


@dataclasses.dataclass
class Keypoints:
    """Fixed-capacity keypoint set: the 16 fields of CudaSift's SiftPoint
    (cudaSift.h:6-22) as tensors of ``max_pts`` slots, with ``num_pts`` and
    ``overflow`` as 0-d int32 tensors."""

    num_pts: torch.Tensor
    xpos: torch.Tensor
    ypos: torch.Tensor
    scale: torch.Tensor
    sharpness: torch.Tensor
    edgeness: torch.Tensor
    orientation: torch.Tensor
    score: torch.Tensor
    ambiguity: torch.Tensor
    match: torch.Tensor
    match_xpos: torch.Tensor
    match_ypos: torch.Tensor
    match_error: torch.Tensor
    subsampling: torch.Tensor
    data: torch.Tensor
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """The extraction settings a configuration file states."""

    num_octaves: int
    init_blur: float
    thresh: float
    max_pts: int
    lowest_scale: float = 0.0
    candidate_fraction: float = 1.0 / 2048.0
    min_candidates: int = 256
    edge_limit: float = 10.0

    # What this reference implements of the settings a file may state.
    IMPLEMENTED = {"scale_up": False, "use_fused": True, "grad_mode": "shift",
                   "fast_gradients": False}

    @classmethod
    def from_dict(cls, d: dict) -> "SiftConfig":
        for k, v in cls.IMPLEMENTED.items():
            if d.get(k, v) != v:
                raise NotImplementedError(f"the reference has no path for {k}={d[k]!r}")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def candidate_capacity(self, height: int, width: int, octave: int) -> int:
        voxels = height * width * NUM_SCALES
        mult = (1, 4, 8, 16, 32)[min(octave, 4)] * 3 ** max(0, octave - 4)
        cap = int(voxels * self.candidate_fraction * mult)
        cap = min(cap, voxels // (48 if octave < 5 else 12))
        cap = max(self.min_candidates, cap)
        cap = min(cap, self.max_pts)
        return (cap + 127) // 128 * 128


# ---- Gaussian taps ----------------------------------------------------------

def gaussian_kernel_1d(radius: int, variance: float) -> np.ndarray:
    j = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(j * j) / (2.0 * variance))
    return (k / k.sum()).astype(np.float32)


def laplace_kernels(num_octaves: int) -> np.ndarray:
    """(num_octaves, 8, 9) taps: scale s of every octave targets sigma
    2^((s-1)/5) over a base blur that starts at 0 (cudaSiftH.cu:439-458)."""
    out = np.zeros((num_octaves, NUM_LAPLACE_SCALES, 2 * LAPLACE_R + 1), np.float64)
    blur = 0.0
    for o in range(num_octaves):
        scale = 2.0 ** (-1.0 / NUM_SCALES)
        diff_scale = 2.0 ** (1.0 / NUM_SCALES)
        for s in range(NUM_LAPLACE_SCALES):
            var = scale * scale - blur * blur
            j = np.arange(0, LAPLACE_R + 1, dtype=np.float64)
            half = np.exp(-(j * j) / (2.0 * var))
            half /= half[0] + 2.0 * half[1:].sum()
            out[o, s, LAPLACE_R:] = half
            out[o, s, :LAPLACE_R] = half[1:][::-1]
            scale *= diff_scale
        blur = math.sqrt(blur * blur + 0.25) / 2.0
    return out.astype(np.float32)


def _taps(taps: np.ndarray, prec: Precision) -> np.ndarray:
    return prec.operand(torch.as_tensor(np.asarray(taps, np.float32))).numpy()


# ---- pyramid ----------------------------------------------------------------

def _edge_rows(img: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    n = img.shape[dim]
    idx = torch.arange(-r, n + r, device=img.device).clamp_(0, n - 1)
    return img.index_select(dim, idx)


def low_pass(img: torch.Tensor, sigma: float, prec: Precision) -> torch.Tensor:
    """9-tap separable Gaussian, clamp-to-edge, vertical then horizontal."""
    taps = _taps(gaussian_kernel_1d(4, sigma * sigma), prec)
    img = prec.operand(img)
    h, w = img.shape
    pv = _edge_rows(img, 4, 0)
    tmp = float(taps[0]) * pv[0:h]
    for j in range(1, 9):
        tmp = tmp + float(taps[j]) * pv[j:j + h]
    ph = _edge_rows(tmp, 4, 1)
    out = float(taps[0]) * ph[:, 0:w]
    for j in range(1, 9):
        out = out + float(taps[j]) * ph[:, j:j + w]
    return out


def scale_down(img: torch.Tensor, prec: Precision) -> torch.Tensor:
    """5-tap Gaussian (variance 0.5) and 2x decimation (cudaSiftD.cu:84-168)."""
    taps = _taps(gaussian_kernel_1d(2, 0.5), prec)
    img = prec.operand(img)
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


def blur_multi(img: torch.Tensor, kernels: np.ndarray, prec: Precision) -> torch.Tensor:
    """The 8 Gaussian scales of one octave: (H, W) -> (8, H, W)."""
    h, w = img.shape
    k = torch.as_tensor(_taps(kernels, prec), device=img.device)
    kv = k[:, :, None, None]
    pv = _edge_rows(prec.operand(img), 4, 0)
    vert = kv[:, 0] * pv[None, 0:h]
    for j in range(1, 9):
        vert = vert + kv[:, j] * pv[None, j:j + h]
    ph = _edge_rows(vert, 4, 2)
    acc = kv[:, 0] * ph[:, :, 0:w]
    for j in range(1, 9):
        acc = acc + kv[:, j] * ph[:, :, j:j + w]
    return acc


# ---- detection ----------------------------------------------------------------

def extrema_mask(dog: torch.Tensor, thresh: float, edge_limit: float) -> torch.Tensor:
    """(5, H, W) strict 3x3x3 extrema of DoG planes 1..5 past ``thresh``,
    with the edge test ``tra^2 < edge_limit * det`` (cudaSiftD.cu:1292-1431);
    border pixels excluded."""
    _, h, w = dog.shape
    neg = torch.full_like(dog[:, :1], -torch.inf)
    pos = torch.full_like(dog[:, :1], torch.inf)
    up = torch.cat([neg, dog[:, :-1]], dim=1)
    dn = torch.cat([dog[:, 1:], neg], dim=1)
    up_n = torch.cat([pos, dog[:, :-1]], dim=1)
    dn_n = torch.cat([dog[:, 1:], pos], dim=1)
    cmax = torch.maximum(torch.maximum(up, dog), dn)
    cmin = torch.minimum(torch.minimum(up_n, dog), dn_n)
    negc = torch.full_like(dog[:, :, :1], -torch.inf)
    posc = torch.full_like(dog[:, :, :1], torch.inf)
    left_max = torch.cat([negc, cmax[:, :, :-1]], dim=2)
    right_max = torch.cat([cmax[:, :, 1:], negc], dim=2)
    left_min = torch.cat([posc, cmin[:, :, :-1]], dim=2)
    right_min = torch.cat([cmin[:, :, 1:], posc], dim=2)
    m3max = torch.maximum(torch.maximum(left_max, cmax), right_max)
    m3min = torch.minimum(torch.minimum(left_min, cmin), right_min)
    center = dog[1:6]
    p8max = torch.maximum(torch.maximum(left_max[1:6], right_max[1:6]),
                          torch.maximum(up[1:6], dn[1:6]))
    p8min = torch.minimum(torch.minimum(left_min[1:6], right_min[1:6]),
                          torch.minimum(up_n[1:6], dn_n[1:6]))
    nbrmax = torch.maximum(torch.maximum(m3max[0:5], m3max[2:7]), p8max)
    nbrmin = torch.minimum(torch.minimum(m3min[0:5], m3min[2:7]), p8min)
    mask = (center > torch.clamp(nbrmax, min=thresh)) | (
        center < torch.clamp(nbrmin, max=-thresh))
    xi = torch.arange(-1, w + 1, device=dog.device).clamp_(0, w - 1)
    yi = torch.arange(-1, h + 1, device=dog.device).clamp_(0, h - 1)
    pc2 = center[:, :, xi]
    pr2 = center[:, yi, :]
    pd = pc2[:, yi, :]
    dxx = 2.0 * center - pc2[:, :, 0:w] - pc2[:, :, 2:2 + w]
    dyy = 2.0 * center - pr2[:, 0:h] - pr2[:, 2:2 + h]
    dxy = 0.25 * (pd[:, 2:2 + h, 2:2 + w] + pd[:, 0:h, 0:w]
                  - pd[:, 0:h, 2:2 + w] - pd[:, 2:2 + h, 0:w])
    tra = dxx + dyy
    det = dxx * dyy - dxy * dxy
    mask = mask & (tra * tra < edge_limit * det)
    yy = torch.arange(h, device=dog.device)
    xx = torch.arange(w, device=dog.device)
    interior = ((yy > 0) & (yy < h - 1))[:, None] & ((xx > 0) & (xx < w - 1))[None, :]
    return mask & interior


def rank_select(mask: torch.Tensor, capacity: int):
    """(src, count, total): the first ``capacity`` set entries of a 1-D mask
    in raster order (0 past ``count``), their count and the pre-clamp total."""
    cum = torch.cumsum(mask.to(torch.int64), dim=0)
    total = cum[-1]
    targets = torch.arange(1, capacity + 1, device=mask.device, dtype=torch.int64)
    src = torch.searchsorted(cum, targets)
    src = torch.where(targets <= total, src, torch.zeros_like(src))
    count = torch.clamp(total, max=capacity).to(torch.int32)
    return src, count, total.to(torch.int32)


@dataclasses.dataclass
class Candidates:
    xpos: torch.Tensor
    ypos: torch.Tensor
    scale: torch.Tensor
    sharpness: torch.Tensor
    edgeness: torch.Tensor
    valid: torch.Tensor


def refine(dog: torch.Tensor, src: torch.Tensor, count: torch.Tensor,
           edge_limit: float, lowest_scale: float) -> Candidates:
    """Subpixel refinement (cudaSiftD.cu:1379-1428) with the per-axis Newton
    fallback when the offset leaves the +-0.5 box."""
    _, h, w = dog.shape
    k = src.shape[0]
    s = src // (h * w)
    rem = src - s * (h * w)
    y = rem // w
    x = rem - y * w
    in_range = torch.arange(k, device=dog.device) < count
    y = torch.clamp(y, 1, h - 2)
    x = torch.clamp(x, 1, w - 2)
    flat = dog.reshape(-1)

    def at(ds, dy, dx):
        return flat[(s + 1 + ds) * (h * w) + (y + dy) * w + (x + dx)]

    val = at(0, 0, 0)
    dxx = 2.0 * val - at(0, 0, -1) - at(0, 0, 1)
    dyy = 2.0 * val - at(0, -1, 0) - at(0, 1, 0)
    dxy = 0.25 * (at(0, 1, 1) + at(0, -1, -1) - at(0, -1, 1) - at(0, 1, -1))
    tra = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = tra * tra < edge_limit * det
    edge = tra * tra / torch.where(det == 0.0, 1e-30, det)
    dx_ = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
    dy_ = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
    ds_ = 0.5 * (at(-1, 0, 0) - at(1, 0, 0))
    dss = 2.0 * val - at(1, 0, 0) - at(-1, 0, 0)
    dxs = 0.25 * (at(1, 0, 1) + at(-1, 0, -1) - at(-1, 0, 1) - at(1, 0, -1))
    dys = 0.25 * (at(1, 1, 0) + at(-1, -1, 0) - at(1, -1, 0) - at(-1, 1, 0))
    idxx = dyy * dss - dys * dys
    idxy = dys * dxs - dxy * dss
    idxs = dxy * dys - dyy * dxs
    denom = idxx * dxx + idxy * dxy + idxs * dxs
    idet = 1.0 / torch.where(denom == 0.0, 1e-30, denom)
    idyy = dxx * dss - dxs * dxs
    idys = dxy * dxs - dxx * dys
    idss = dxx * dyy - dxy * dxy
    pdx = idet * (idxx * dx_ + idxy * dy_ + idxs * ds_)
    pdy = idet * (idxy * dx_ + idyy * dy_ + idys * ds_)
    pds = idet * (idxs * dx_ + idys * dy_ + idss * ds_)
    out_of_box = (pdx.abs() > 0.5) | (pdy.abs() > 0.5) | (pds.abs() > 0.5)

    def safe_div(a, b):
        return a / torch.where(b == 0.0, 1e-30, b)

    pdx = torch.where(out_of_box, safe_div(dx_, dxx), pdx)
    pdy = torch.where(out_of_box, safe_div(dy_, dyy), pdy)
    pds = torch.where(out_of_box, safe_div(ds_, dss), pds)
    dval = 0.5 * (dx_ * pdx + dy_ * pdy + ds_ * pds)
    factor = 1.0 / NUM_SCALES
    sc = torch.exp2(s.to(torch.float32) * factor) * torch.exp2(pds * factor)
    valid = in_range & edge_ok & (sc >= lowest_scale)
    z = torch.zeros((), dtype=torch.float32, device=dog.device)
    return Candidates(
        xpos=torch.where(valid, x.to(torch.float32) + pdx, z),
        ypos=torch.where(valid, y.to(torch.float32) + pdy, z),
        scale=torch.where(valid, sc, z),
        sharpness=torch.where(valid, val + dval, z),
        edgeness=torch.where(valid, edge, z),
        valid=valid)


# ---- orientation and descriptors ------------------------------------------------
# Patch geometry: scale <= 1.72 reads a (32, 32) patch with margin 15, larger
# scales (48, 64) with margin 22; sampling positions are clamped into the
# image box, the patch origin is max(floor(.) - margin, 0), and reads past the
# bottom or right border repeat the edge.
GEOM_SMALL = (32, 32, 15)
GEOM_LARGE = (48, 64, 22)
SMALL_MAX_SCALE = 1.72
NUM_BINS = 32
ATAN_POLY = (-0.0040540580, 0.0218612288, -0.0559098861, 0.0964200441,
             -0.1390853351, 0.1994653599, -0.3332985605, 0.9999993329)


@dataclasses.dataclass
class Patches:
    read: object
    x: torch.Tensor
    y: torch.Tensor
    ox: torch.Tensor
    oy: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor


def patches(img, xpos, ypos, scale) -> Patches:
    h, w = img.shape
    x = torch.clamp(xpos, 0.0, float(w - 1))
    y = torch.clamp(ypos, 0.0, float(h - 1))
    small = scale <= SMALL_MAX_SCALE
    rows, cols, margin = (torch.where(small, a, b) for a, b in zip(GEOM_SMALL, GEOM_LARGE))
    ox = torch.clamp(torch.floor(x).to(torch.int64) - margin, min=0)
    oy = torch.clamp(torch.floor(y).to(torch.int64) - margin, min=0)
    flat = img.reshape(-1)

    def read(r, c):
        shape = (-1,) + (1,) * (max(r.dim(), c.dim()) - 1)
        rr = torch.clamp(oy.reshape(shape) + r, 0, h - 1)
        cc = torch.clamp(ox.reshape(shape) + c, 0, w - 1)
        return flat[rr * w + cc]

    return Patches(read, x, y, ox, oy, rows, cols)


def atan2_poly(y, x):
    absx, absy = x.abs(), y.abs()
    mx, mn = torch.maximum(absx, absy), torch.minimum(absx, absy)
    z = mn / torch.where(mx == 0.0, 1.0, mx)
    s = z * z
    r = torch.full_like(z, ATAN_POLY[0])
    for c in ATAN_POLY[1:]:
        r = r * s + c
    r = r * z
    r = torch.where(absy > absx, 1.5707963268 - r, r)
    r = torch.where(x < 0, 3.1415926536 - r, r)
    return torch.where(y < 0, -r, r)


def fast_atan2(y, x):
    """FastAtan2 (cudaSiftD.cu:295-306)."""
    absx, absy = x.abs(), y.abs()
    mx, mn = torch.maximum(absx, absy), torch.minimum(absx, absy)
    a = mn / torch.where(mx == 0.0, 1.0, mx)
    s = a * a
    r = ((-0.0464964749 * s + 0.15931422) * s - 0.327622764) * s * a + a
    r = torch.where(absy > absx, 1.57079637 - r, r)
    r = torch.where(x < 0, 3.14159274 - r, r)
    return torch.where(y < 0, -r, r)


def orientations(img, xpos, ypos, scale):
    """(primary, secondary, has_second): 32-bin gradient histograms of a
    13x13 grid around each keypoint, smoothed [1,4,6,4,1], two peaks
    parabola-refined (cudaSiftD.cu:972-1057)."""
    p = patches(img, xpos, ypos, scale)
    flx, fly = torch.floor(p.x), torch.floor(p.y)
    fx, fy = p.x - flx, p.y - fly
    cbase = flx.to(torch.int64) - p.ox - 6
    rbase = fly.to(torch.int64) - p.oy - 6
    n = fx.shape[0]
    dev = fx.device
    u = torch.arange(13, device=dev)
    rows = torch.clamp(rbase[:, None] + u, 0, 31)[:, :, None]
    cols = torch.clamp(cbase[:, None] + u, 0, 31)[:, None, :]
    fxv, fyv = fx[:, None, None], fy[:, None, None]
    read = p.read
    v = (1.0 - fyv) * ((1.0 - fxv) * read(rows, cols) + fxv * read(rows, cols + 1)) \
        + fyv * ((1.0 - fxv) * read(rows + 1, cols) + fxv * read(rows + 1, cols + 1))
    dx = v[:, 1:12, 2:13] - v[:, 1:12, 0:11]
    dy = v[:, 2:13, 1:12] - v[:, 0:11, 1:12]
    theta = atan2_poly(dy, dx)
    bins = torch.floor(16.0 * theta / 3.1416 + 16.5).to(torch.int64)
    bins = torch.where(bins > 31, 0, bins)
    d = torch.arange(11, device=dev, dtype=torch.float32) - 5.0
    dist2 = d[None, :] * d[None, :] + d[:, None] * d[:, None]
    i2s2 = -1.0 / (2.0 * 1.5 * 1.5 * scale * scale)
    wgt = torch.sqrt(dx * dx + dy * dy) * torch.exp(i2s2[:, None, None] * dist2)
    onehot = bins.reshape(n, 121, 1) == torch.arange(NUM_BINS, device=dev)
    hist = torch.where(onehot, wgt.reshape(n, 121, 1), 0.0).sum(dim=1)

    sm = (6.0 * hist + 4.0 * (torch.roll(hist, 1, dims=1) + torch.roll(hist, -1, dims=1))
          + torch.roll(hist, 2, dims=1) + torch.roll(hist, -2, dims=1))
    peaks = torch.where((sm > torch.roll(sm, 1, dims=1)) & (sm >= torch.roll(sm, -1, dims=1)),
                        sm, 0.0)
    max1 = peaks.max(dim=1).values
    i1 = torch.argmax(peaks, dim=1)
    c = torch.arange(NUM_BINS, device=dev)
    masked = torch.where(c[None, :] == i1[:, None], -torch.inf, peaks)
    max2 = masked.max(dim=1).values
    i2 = torch.argmax(masked, dim=1)

    def interp(i, m):
        v1 = torch.gather(sm, 1, ((i + 1) % 32)[:, None])[:, 0]
        v2 = torch.gather(sm, 1, ((i - 1) % 32)[:, None])[:, 0]
        den = 2.0 * m - v1 - v2
        peak = i.to(torch.float32) + 0.5 * (v1 - v2) / torch.where(den == 0.0, 1e-30, den)
        return 11.25 * torch.where(peak < 0.0, peak + 32.0, peak)

    return interp(i1, max1), interp(i2, max2), max2 > 0.8 * max1


def _grid(device):
    g = torch.arange(256, device=device)
    return (g % 16).to(torch.float32) - 7.5, (g // 16).to(torch.float32) - 7.5


def spatial_weights(device) -> torch.Tensor:
    """(16, 256) trilinear weights of the 4x4 cells over the 16x16 grid."""
    gx, gy = _grid(device)
    cy = torch.floor((gy + 7.5 + 2.0) / 4.0) - 1.0
    fy = (gy + 7.5 - 1.5) / 4.0 - cy
    cx = torch.floor((gx + 7.5 + 2.0) / 4.0) - 1.0
    fx = (gx + 7.5 - 1.5) / 4.0 - cx
    rc = torch.arange(16, device=device)
    r = (rc // 4).to(torch.float32)[:, None]
    c = (rc % 4).to(torch.float32)[:, None]
    wr = (cy == r) * (1.0 - fy) + (cy + 1.0 == r) * fy
    wc = (cx == c) * (1.0 - fx) + (cx + 1.0 == c) * fx
    return wr * wc


def _tent(p, s):
    return torch.clamp(1.0 - (p.to(torch.float32) - s).abs(), min=0.0)


def _hat(d):
    return [torch.clamp(1.0 - (d - o).abs(), min=0.0) for o in (-1.0, 0.0, 1.0)]


def shift_gradients(read, lx0, ly0, s12, ori_deg, rows, cols):
    """(dx, dy), each (N, 256): rotation-aligned gradient fields
    ``Dx(q) = S(q; +(cos, sin)) - S(q; -(cos, sin))`` and
    ``Dy(q) = S(q; (-sin, cos)) - S(q; (sin, -cos))`` at integer pixels
    (S a bilinear sample at an offset), sampled bilinearly at the rotated
    16x16 grid (spacing ``s12``, the reference's +0.5 sample shift), kept
    off the patch's outer rows and columns."""
    gx, gy = _grid(lx0.device)
    th = (2.0 * 3.1415 / 360.0) * ori_deg
    cosa = torch.cos(th)[:, None]
    sina = torch.sin(th)[:, None]
    s12 = s12[:, None]
    xs = lx0[:, None] + gx * (s12 * cosa) - gy * (s12 * sina) + 0.5
    ys = ly0[:, None] + gx * (s12 * sina) + gy * (s12 * cosa) + 0.5
    pmax = (rows - 1).to(torch.float32)[:, None]
    qmax = (cols - 1).to(torch.float32)[:, None]

    def bilinear(sample, sy, sx):
        p0 = torch.floor(sy).to(torch.int64)
        q0 = torch.floor(sx).to(torch.int64)
        wr0, wr1 = _tent(p0, sy), _tent(p0 + 1, sy)
        wc0, wc1 = _tent(q0, sx), _tent(q0 + 1, sx)
        top = sample(p0, q0) * wc0 + sample(p0, q0 + 1) * wc1
        bot = sample(p0 + 1, q0) * wc0 + sample(p0 + 1, q0 + 1) * wc1
        return wr0 * top + wr1 * bot

    sx = torch.minimum(torch.clamp(xs - 0.5, min=1.0), qmax - 1.0)
    sy = torch.minimum(torch.clamp(ys - 0.5, min=1.0), pmax - 1.0)
    hc, hs = _hat(cosa), _hat(sina)
    taps = [(jr, jc) for jr in (-1, 0, 1) for jc in (-1, 0, 1)]
    wx = {(jr, jc): hs[jr + 1] * hc[jc + 1] - hs[1 - jr] * hc[1 - jc] for jr, jc in taps}
    wy = {(jr, jc): hc[jr + 1] * hs[1 - jc] - hc[1 - jr] * hs[jc + 1] for jr, jc in taps}

    def field(weights):
        def sample(p, q):
            acc = torch.zeros_like(xs)
            for jr, jc in taps:
                acc = acc + weights[(jr, jc)] * read(p + jr, q + jc)
            return acc
        return sample

    return bilinear(field(wx), sy, sx), bilinear(field(wy), sy, sx)


def bin_descriptors(dx, dy, prec: Precision) -> torch.Tensor:
    """(N, 128) descriptors: trilinear binning into 4x4 cells x 8 angles
    under a Gaussian window, then L2 -> clamp 0.2 -> L2
    (cudaSiftD.cu:347-409)."""
    n = dx.shape[0]
    gx, gy = _grid(dx.device)
    gweight = torch.exp(-(gx * gx + gy * gy) / 128.0)
    grad = torch.sqrt(dx * dx + dy * dy) * gweight
    angf = 4.0 / 3.1415 * fast_atan2(dy, dx) + 4.0
    angi_raw = torch.floor(angf)
    frac = angf - angi_raw
    angi = torch.remainder(angi_raw.to(torch.int64), 8)
    angp = torch.where(angi == 7, 0, angi + 1)
    a = torch.arange(8, device=dx.device)
    ga = ((angi[..., None] == a) * (grad * (1.0 - frac))[..., None]
          + (angp[..., None] == a) * (grad * frac)[..., None])
    with prec.products():
        desc = torch.einsum("rs,nsa->nra", prec.operand(spatial_weights(dx.device)),
                            prec.operand(ga))
    d = desc.reshape(n, 128)
    n1 = torch.rsqrt(torch.clamp((d * d).sum(dim=1, keepdim=True), min=1e-30))
    t1 = torch.clamp(d * n1, max=0.2)
    n2 = torch.rsqrt(torch.clamp((t1 * t1).sum(dim=1, keepdim=True), min=1e-30))
    return t1 * n2


def descriptors(img, xpos, ypos, scale, ori, prec: Precision) -> torch.Tensor:
    p = patches(img, xpos, ypos, scale)
    dx, dy = shift_gradients(p.read, p.x - p.ox.to(torch.float32),
                             p.y - p.oy.to(torch.float32), (12.0 / 16.0) * scale,
                             ori, p.rows, p.cols)
    return bin_descriptors(dx, dy, prec)


# ---- the octaves and the merge ---------------------------------------------------

def _compact(fields: dict, valid: torch.Tensor, capacity: int):
    src, count, total = rank_select(valid, capacity)
    live = torch.arange(capacity, device=valid.device) < count
    out = {}
    for k, v in fields.items():
        g = v[src]
        mask = live.reshape((capacity,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(mask, g, torch.zeros((), dtype=v.dtype, device=v.device))
    return out, count, total


def _octave(base, kernels, cfg: SiftConfig, subsampling: float, capacity: int,
            prec: Precision):
    blur = blur_multi(base, kernels, prec)
    dog = blur[1:] - blur[:-1]
    mask = extrema_mask(dog, cfg.thresh, cfg.edge_limit)
    src, count, total = rank_select(mask.reshape(-1), capacity)
    cands = refine(dog, src, count, cfg.edge_limit, cfg.lowest_scale / subsampling)
    base = prec.operand(base)
    live = cands.valid
    scale_safe = torch.where(live, cands.scale, 1.0)
    ori1, ori2, has2 = orientations(base, cands.xpos, cands.ypos, scale_safe)
    desc1 = descriptors(base, cands.xpos, cands.ypos, scale_safe, ori1, prec)
    desc2 = descriptors(base, cands.xpos, cands.ypos, scale_safe, ori2, prec)
    has2 = has2 & live
    z = torch.zeros((), dtype=torch.float32, device=base.device)
    fields = {k: torch.cat([getattr(cands, k)] * 2)
              for k in ("xpos", "ypos", "scale", "sharpness", "edgeness")}
    fields["orientation"] = torch.cat([torch.where(live, ori1, z), torch.where(live, ori2, z)])
    fields["data"] = torch.cat([torch.where(live[:, None], desc1, z),
                                torch.where(has2[:, None], desc2, z)])
    valid = torch.cat([live, has2])
    for k in ("xpos", "ypos", "scale"):
        fields[k] = fields[k] * subsampling
    fields["subsampling"] = torch.where(valid, subsampling, 0.0)
    return fields, valid, total - count


def extract(image: torch.Tensor, cfg: SiftConfig, prec: Precision = FLOAT32) -> Keypoints:
    """Keypoints of one (H, W) float32 frame, on the frame's device."""
    dev = image.device
    low = low_pass(image.to(torch.float32), max(cfg.init_blur, 0.001), prec)
    kernels = laplace_kernels(cfg.num_octaves)
    bases = [low]
    for _ in range(cfg.num_octaves - 1):
        bases.append(scale_down(bases[-1], prec))
    all_fields, all_valid = [], []
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    for o in reversed(range(cfg.num_octaves)):
        oh, ow = bases[o].shape
        cap = cfg.candidate_capacity(oh, ow, o)
        fields, valid, dropped = _octave(bases[o].contiguous(), kernels[o], cfg,
                                         float(2 ** o), cap, prec)
        all_fields.append(fields)
        all_valid.append(valid)
        overflow = overflow + dropped
    merged = {k: torch.cat([f[k] for f in all_fields]) for k in all_fields[0]}
    merged, num_pts, total = _compact(merged, torch.cat(all_valid), cfg.max_pts)
    n = cfg.max_pts

    def z():
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return Keypoints(
        num_pts=num_pts, xpos=merged["xpos"], ypos=merged["ypos"], scale=merged["scale"],
        sharpness=merged["sharpness"], edgeness=merged["edgeness"],
        orientation=merged["orientation"], score=z(), ambiguity=z(),
        match=torch.full((n,), -1, dtype=torch.int32, device=dev),
        match_xpos=z(), match_ypos=z(), match_error=z(),
        subsampling=merged["subsampling"], data=merged["data"],
        overflow=(overflow + total - num_pts).to(torch.int32))
