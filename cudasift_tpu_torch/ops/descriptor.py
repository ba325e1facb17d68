"""128-D SIFT descriptors (ExtractSiftDescriptorsCONSTNew,
cudaSiftD.cu:308-417): the plain version of phases 4-5 of the fused
orientation+descriptor kernel (``ops/cuda/orient_desc.py``) and, with the
split geometry ``texture.SPLIT_DESC`` and the ``"exact"`` sampler, of the
descriptor kernel (``ops/cuda/descriptor.py``).

Geometry (cudaSiftD.cu:330-343): a 16x16 grid rotated by the keypoint
orientation with spacing (12/16)*scale and the reference's +0.5 sample
shift. Three gradient samplers:

- ``"exact"`` -- 4 bilinear taps per sample at the rotated unit offsets
  +-(cos, sin) and +-(-sin, cos), the reference arithmetic;
- ``"shift"`` -- rotation-aligned gradient fields
  ``Dx(q) = S(q; +(cos, sin)) - S(q; -(cos, sin))`` and
  ``Dy(q) = S(q; (-sin, cos)) - S(q; (sin, -cos))`` at integer pixels
  (S = bilinear sample at an offset), then sampled bilinearly at the grid
  point. Equal to the exact taps convolved with a 2 px hat;
- ``"fast"`` -- the unrotated central-difference fields
  ``Gx(p, q) = I(p, q+1) - I(p, q-1)`` and ``Gy(p, q) = I(p+1, q) - I(p-1, q)``
  sampled bilinearly at the grid point (the shift mode's clip), then rotated
  into the keypoint frame: ``dx = cos*Gx + sin*Gy``, ``dy = cos*Gy - sin*Gx``.
  Deviates from ``"exact"`` by O(h^2) curvature terms.

Binning is trilinear into 4x4 cells x 8 angles with a Gaussian window,
then L2 -> clamp 0.2 -> L2 (cudaSiftD.cu:347-409).
"""

from __future__ import annotations

import torch

from .texture import FUSED, Geometry, fast_atan2, keypoint_patches


def _grid(device):
    g = torch.arange(256, device=device)
    gx = (g % 16).to(torch.float32) - 7.5
    gy = (g // 16).to(torch.float32) - 7.5
    return gx, gy


def spatial_weights(device) -> torch.Tensor:
    """(16, 256) trilinear spatial weights ``W[4*row_cell + col_cell, s]``
    of grid sample ``s`` (cudaSiftD.cu:347-386)."""
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
    # 3-tap hat weights of a fractional offset d in [-1, 1]:
    # S_d(v)[i] = sum_t hat(d)[t+1] * v[i+t].
    return [torch.clamp(1.0 - (d - o).abs(), min=0.0) for o in (-1.0, 0.0, 1.0)]


def sample_gradients(read, lx0, ly0, s12, ori_deg, rows, cols, mode: str):
    """Gradients (dx, dy), each (N, 256), at the rotated 16x16 grid.

    ``read`` is a ``texture.Patches.read``; ``lx0``/``ly0`` (N,) the
    keypoint position in patch coordinates, ``s12`` (N,) the grid spacing,
    ``ori_deg`` (N,) the orientation, ``rows``/``cols`` (N,) the patch size
    (sample coordinates clip to it as the fused kernel's do).
    """
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

    if mode == "exact":
        vals = []
        for tx, ty in ((cosa, sina), (-cosa, -sina), (-sina, cosa), (sina, -cosa)):
            sx = torch.minimum(torch.clamp(xs + tx - 0.5, min=0.0), qmax)
            sy = torch.minimum(torch.clamp(ys + ty - 0.5, min=0.0), pmax)
            vals.append(bilinear(read, sy, sx))
        return vals[0] - vals[1], vals[2] - vals[3]
    if mode not in ("shift", "fast"):
        raise ValueError(f"mode must be exact|shift|fast, got {mode!r}")

    # Both field samplers keep off the patch's outer rows and columns, as the
    # fused kernel's do (its fields wrap around there).
    sx = torch.minimum(torch.clamp(xs - 0.5, min=1.0), qmax - 1.0)
    sy = torch.minimum(torch.clamp(ys - 0.5, min=1.0), pmax - 1.0)
    if mode == "fast":
        def gx_field(p, q):
            return read(p, q + 1) - read(p, q - 1)

        def gy_field(p, q):
            return read(p + 1, q) - read(p - 1, q)

        sgx = bilinear(gx_field, sy, sx)
        sgy = bilinear(gy_field, sy, sx)
        return cosa * sgx + sina * sgy, cosa * sgy - sina * sgx

    hc = _hat(cosa)
    hs = _hat(sina)
    taps = [(jr, jc) for jr in (-1, 0, 1) for jc in (-1, 0, 1)]
    wx = {(jr, jc): hs[jr + 1] * hc[jc + 1] - hs[1 - jr] * hc[1 - jc]
          for jr, jc in taps}
    wy = {(jr, jc): hc[jr + 1] * hs[1 - jc] - hc[1 - jr] * hs[jc + 1]
          for jr, jc in taps}

    def field(weights):
        def sample(p, q):
            acc = torch.zeros_like(xs)
            for jr, jc in taps:
                acc = acc + weights[(jr, jc)] * read(p + jr, q + jc)
            return acc
        return sample

    return bilinear(field(wx), sy, sx), bilinear(field(wy), sy, sx)


def bin_descriptors(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """(N, 128) normalized descriptors from (N, 256) grid gradients, in the
    reference's lane order ``d = 8*(4*row_cell + col_cell) + angle``."""
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
          + (angp[..., None] == a) * (grad * frac)[..., None])   # (N, 256, 8)
    desc = torch.einsum("rs,nsa->nra", spatial_weights(dx.device), ga)
    return normalize(desc.reshape(n, 128))


def normalize(d: torch.Tensor) -> torch.Tensor:
    """L2 -> clamp 0.2 -> L2 (cudaSiftD.cu:390-409)."""
    n1 = torch.rsqrt(torch.clamp((d * d).sum(dim=1, keepdim=True), min=1e-30))
    t1 = torch.clamp(d * n1, max=0.2)
    n2 = torch.rsqrt(torch.clamp((t1 * t1).sum(dim=1, keepdim=True), min=1e-30))
    return t1 * n2


def extract_descriptors(img: torch.Tensor, xpos: torch.Tensor, ypos: torch.Tensor,
                        scale: torch.Tensor, orientation: torch.Tensor,
                        mode: str = "shift", geom: Geometry = FUSED) -> torch.Tensor:
    """(N, 128) descriptors of oriented keypoints (orientation in degrees),
    with the patch geometry ``geom`` (``texture.keypoint_patches``)."""
    p = keypoint_patches(img, xpos, ypos, scale, geom)
    dx, dy = sample_gradients(
        p.read, p.x - p.ox.to(torch.float32), p.y - p.oy.to(torch.float32),
        (12.0 / 16.0) * scale, orientation, p.rows, p.cols, mode)
    return bin_descriptors(dx, dy)
