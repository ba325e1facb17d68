"""DoG extrema detection, compaction and subpixel refinement.

The plain PyTorch stages of detection (FindPointsMultiNew,
cudaSiftD.cu:1292-1431):

1. ``extrema_mask`` -- dense strict 3x3x3 extremum mask over the 5 middle
   DoG planes with the edge-response test; the plain version of the mask
   half of the DoG kernel (``ops/cuda/dog.py``);
2. ``compact_mask`` -- raster-order compaction of the mask into a fixed
   capacity: an inclusive prefix sum and a binary search for each rank.
   Deterministic, and it never reads a count back to the host;
3. ``refine_candidates`` -- the reference's Hessian-adjugate subpixel
   solve with its per-axis Newton fallback; the plain version of the
   refine kernel (``ops/cuda/refine.py``).

Border pixels are excluded outright: the reference's clamped loads make the
centre compare against itself at image borders.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import NUM_SCALES


@dataclasses.dataclass
class Candidates:
    """Fixed-capacity per-octave keypoint candidates (octave coordinates)."""

    xpos: torch.Tensor       # (K,) f32, subpixel
    ypos: torch.Tensor       # (K,) f32, subpixel
    scale: torch.Tensor      # (K,) f32, octave-relative scale
    sharpness: torch.Tensor  # (K,) f32, refined DoG response
    edgeness: torch.Tensor   # (K,) f32, tra^2/det
    valid: torch.Tensor      # (K,) bool


def extrema_mask(dog: torch.Tensor, thresh: float,
                 edge_limit: float | None = None) -> torch.Tensor:
    """(5, H, W) bool mask of strict 3x3x3 extrema exceeding ``thresh``.

    Plane s of the result is DoG plane s+1 compared against planes s and
    s+2 (cudaSiftD.cu:1308,1328-1357). With ``edge_limit`` set the
    edge-response rejection ``tra^2 < edge_limit*det`` (cudaSiftD.cu:1390)
    is applied here, densely, with the arithmetic of ``refine_candidates``.
    """
    _, h, w = dog.shape
    neg = torch.full_like(dog[:, :1], -torch.inf)
    pos = torch.full_like(dog[:, :1], torch.inf)
    up = torch.cat([neg, dog[:, :-1]], dim=1)       # row y-1
    dn = torch.cat([dog[:, 1:], neg], dim=1)        # row y+1
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
    # Centre plane without the centre pixel: side column triples plus the
    # centre column's y+-1.
    p8max = torch.maximum(torch.maximum(left_max[1:6], right_max[1:6]),
                          torch.maximum(up[1:6], dn[1:6]))
    p8min = torch.minimum(torch.minimum(left_min[1:6], right_min[1:6]),
                          torch.minimum(up_n[1:6], dn_n[1:6]))
    nbrmax = torch.maximum(torch.maximum(m3max[0:5], m3max[2:7]), p8max)
    nbrmin = torch.minimum(torch.minimum(m3min[0:5], m3min[2:7]), p8min)

    mask = (center > torch.clamp(nbrmax, min=thresh)) | (
        center < torch.clamp(nbrmin, max=-thresh))
    if edge_limit is not None:
        # Same operations, in the same order, as refine_candidates.
        xi = torch.arange(-1, w + 1, device=dog.device).clamp_(0, w - 1)
        yi = torch.arange(-1, h + 1, device=dog.device).clamp_(0, h - 1)
        pc2 = center[:, :, xi]
        pr2 = center[:, yi, :]
        pd = pc2[:, yi, :]
        dxx = 2.0 * center - pc2[:, :, 0:w] - pc2[:, :, 2:2 + w]
        dyy = 2.0 * center - pr2[:, 0:h] - pr2[:, 2:2 + h]
        dxy = 0.25 * (
            pd[:, 2:2 + h, 2:2 + w]
            + pd[:, 0:h, 0:w]
            - pd[:, 0:h, 2:2 + w]
            - pd[:, 2:2 + h, 0:w]
        )
        tra = dxx + dyy
        det = dxx * dyy - dxy * dxy
        mask = mask & (tra * tra < edge_limit * det)
    yy = torch.arange(h, device=dog.device)
    xx = torch.arange(w, device=dog.device)
    interior = ((yy > 0) & (yy < h - 1))[:, None] & ((xx > 0) & (xx < w - 1))[None, :]
    return mask & interior


def rank_select(mask: torch.Tensor, capacity: int):
    """Positions of the first ``capacity`` set entries of a 1-D bool mask.

    Returns (src (capacity,) int64, count () int32, total () int32): ``src[k]``
    is the index of the (k+1)-th set entry for ``k < count`` and 0 past it;
    ``total`` is the number of set entries before the clamp. Entries past
    capacity are dropped. Order is raster order, whatever the device.
    """
    cum = torch.cumsum(mask.to(torch.int64), dim=0)
    total = cum[-1]
    targets = torch.arange(1, capacity + 1, device=mask.device, dtype=torch.int64)
    src = torch.searchsorted(cum, targets)
    src = torch.where(targets <= total, src, torch.zeros_like(src))
    count = torch.clamp(total, max=capacity).to(torch.int32)
    return src, count, total.to(torch.int32)


def compact_mask(mask: torch.Tensor, capacity: int, with_total: bool = False):
    """Compact a boolean mask into raster-ordered flat indices.

    Returns (flat_indices (capacity,) int32, count () int32), plus the
    pre-clamp total () int32 when ``with_total``. Entries past ``count`` are
    zero; set entries past capacity are dropped (and show as
    ``total - count``).
    """
    src, count, total = rank_select(mask.reshape(-1), capacity)
    idx = src.to(torch.int32)
    if with_total:
        return idx, count, total
    return idx, count


def refine_candidates(
    dog: torch.Tensor,
    flat_idx: torch.Tensor,
    count: torch.Tensor,
    edge_limit: float,
    lowest_scale: float,
    factor: float = 1.0 / NUM_SCALES,
) -> Candidates:
    """Subpixel refinement of compacted candidates (cudaSiftD.cu:1379-1428),
    including its negated second-derivative convention and the per-axis
    Newton fallback when the offset leaves the +-0.5 box.

    ``dog`` is the (7, H, W) stack, ``flat_idx`` indexes the (5, H, W) mask
    grid (plane s there is DoG plane s+1). Slots at or past ``count`` come
    back zero and invalid. ``lowest_scale`` is already divided by the octave
    subsampling by the caller.
    """
    _, h, w = dog.shape
    k = flat_idx.shape[0]
    fi = flat_idx.to(torch.int64)
    s = fi // (h * w)
    rem = fi - s * (h * w)
    y = rem // w
    x = rem - y * w
    slot = torch.arange(k, device=dog.device)
    in_range = slot < count
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
    det_safe = torch.where(det == 0.0, 1e-30, det)
    edge = tra * tra / det_safe

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
    sc = torch.exp2(s.to(torch.float32) * factor) * torch.exp2(pds * factor)
    valid = in_range & edge_ok & (sc >= lowest_scale)

    z = torch.zeros((), dtype=torch.float32, device=dog.device)
    return Candidates(
        xpos=torch.where(valid, x.to(torch.float32) + pdx, z),
        ypos=torch.where(valid, y.to(torch.float32) + pdy, z),
        scale=torch.where(valid, sc, z),
        sharpness=torch.where(valid, val + dval, z),
        edgeness=torch.where(valid, edge, z),
        valid=valid,
    )
