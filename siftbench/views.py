"""The frames a traffic mix hands the program, made on the device.

One dead-leaves scene canvas (the recipe of ``make_leaves_image`` in the
program's ``utils/synth.py``, copied here so the yardstick cannot move: one
opaque disc per 300 px of uniform grey 0..255, radii 10-160 px with density
~ r^-3, painted one over another on a mid-grey field, then lightly smoothed)
is painted once per run at ``canvas_scale`` times the frame's size, from the
mix's ``scene_seed``: every run sees the same scene, so the work a request
does (its point counts, and the matcher's n1 x n2) does not move with the
run's seed. Every view is a homography of the canvas sampled bilinearly at
the frame's size, made from the run's seed, and lies wholly inside the
canvas:

- ``path``: ``count`` consecutive views along a closed camera path about the
  canvas's centre (a few seeded harmonics of rotation, shift and log-scale,
  scaled so that the largest step between neighbours is ``step_fraction`` of
  the stated limits);
- ``pairs``: ``count`` pairs, view B being view A under a seeded homography
  (rotation, scale, shift and perspective drawn uniformly within the stated
  limits), each pair placed at a seeded spot where both lie inside the
  canvas.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags``."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def paint_canvas(h: int, w: int, seed: int, device: torch.device) -> torch.Tensor:
    """(h, w) float32 dead-leaves canvas on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "canvas"))
    rmin, rmax = 10.0, 160.0
    n = h * w // 300

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)

    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    r = 1.0 / torch.sqrt(u * (rmin ** -2 - rmax ** -2) + rmax ** -2)
    cx = uniform(-rmax, w + rmax)
    cy = uniform(-rmax, h + rmax)
    grey = uniform(0.0, 255.0).to(torch.float32)
    x0 = torch.clamp(torch.floor(cx - r), min=0).to(torch.int64)
    x1 = torch.clamp(torch.floor(cx + r) + 1, max=w).to(torch.int64)
    y0 = torch.clamp(torch.floor(cy - r), min=0).to(torch.int64)
    y1 = torch.clamp(torch.floor(cy + r) + 1, max=h).to(torch.int64)
    bw = torch.clamp(x1 - x0, min=0)
    bh = torch.clamp(y1 - y0, min=0)
    area = (bw * bh).cpu().numpy()
    cum = np.concatenate([[0], np.cumsum(area)])
    # The topmost (last painted) disc over each pixel, over chunks of discs
    # of at most 2**24 box pixels (or one disc).
    top = torch.full((h * w,), -1, dtype=torch.int64, device=device)
    start = 0
    while start < n:
        end = max(start + 1, int(np.searchsorted(cum, cum[start] + 2 ** 24, side="right")) - 1)
        counts = torch.as_tensor(area[start:end], device=device)
        disc = torch.repeat_interleave(torch.arange(start, end, device=device), counts)
        first = torch.cumsum(counts, 0) - counts
        local = torch.arange(disc.shape[0], device=device) - torch.repeat_interleave(first, counts)
        py = y0[disc] + local // bw[disc]
        px = x0[disc] + local % bw[disc]
        inside = (px - cx[disc]) ** 2 + (py - cy[disc]) ** 2 <= r[disc] ** 2
        top.scatter_reduce_(0, (py * w + px)[inside], disc[inside], reduce="amax")
        start = end
    img = torch.where(top >= 0, grey[top.clamp(min=0)], 128.0).reshape(h, w)
    for _ in range(2):
        img = (img + torch.roll(img, 1, 0) + torch.roll(img, 1, 1) + torch.roll(img, -1, 0)) / 4
    return img.contiguous()


def similarity(theta_deg: float, scale: float, tx: float, ty: float,
               cx: float, cy: float) -> np.ndarray:
    """(3, 3) rotation by ``theta_deg`` and scale about (cx, cy), then a
    shift of (tx, ty)."""
    t = math.radians(theta_deg)
    a = scale * np.array([[math.cos(t), -math.sin(t)], [math.sin(t), math.cos(t)]])
    m = np.eye(3)
    m[:2, :2] = a
    m[:2, 2] = np.array([cx, cy]) - a @ np.array([cx, cy]) + np.array([tx, ty])
    return m


def corners(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """(4, 2) images under ``m`` of the frame's corner pixels."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64).T
    p = m @ c
    return (p[:2] / p[2]).T


def path_maps(spec: dict, h: int, w: int, ch: int, cw: int, seed: int) -> list[np.ndarray]:
    """View-to-canvas homographies of ``spec["count"]`` views along a closed
    path centred on the canvas."""
    n = int(spec["count"])
    rng = np.random.default_rng(derive(seed, "path"))
    t = np.arange(n + 1) / n
    harmonics = np.arange(1, int(spec.get("harmonics", 3)) + 1)

    def loop():
        amp = rng.uniform(0.3, 1.0, len(harmonics)) / harmonics
        phase = rng.uniform(0, 2 * np.pi, len(harmonics))
        return (amp[:, None] * np.sin(2 * np.pi * harmonics[:, None] * t + phase[:, None])).sum(0)

    frac = float(spec.get("step_fraction", 0.9))
    lo, hi = spec["scale_range"]
    rot, logs, sx, sy = loop(), loop(), loop(), loop()
    rot *= frac * spec["max_rot_deg"] / np.abs(np.diff(rot)).max()
    logs *= frac * min(math.log(hi), -math.log(lo)) / np.abs(np.diff(logs)).max()
    step = np.hypot(np.diff(sx), np.diff(sy)).max()
    sx *= frac * spec["max_shift_px"] / step
    sy *= frac * spec["max_shift_px"] / step
    maps = []
    for k in range(n):
        m = similarity(rot[k], math.exp(logs[k]), sx[k], sy[k], (w - 1) / 2, (h - 1) / 2)
        shift = np.eye(3)
        shift[:2, 2] = [(cw - w) / 2, (ch - h) / 2]
        maps.append(shift @ m)
    return maps


def pair_maps(spec: dict, h: int, w: int, ch: int, cw: int, seed: int):
    """(maps of views A, maps of views B, homographies A -> B) of
    ``spec["count"]`` pairs."""
    n = int(spec["count"])
    rng = np.random.default_rng(derive(seed, "pairs"))
    maps_a, maps_b, truths = [], [], []
    for _ in range(n):
        rot = rng.uniform(-1, 1) * spec["max_rot_deg"]
        scale = rng.uniform(*spec["scale_range"])
        tx = rng.uniform(-1, 1) * spec["max_shift_frac"] * w
        ty = rng.uniform(-1, 1) * spec["max_shift_frac"] * h
        g = similarity(rot, scale, tx, ty, (w - 1) / 2, (h - 1) / 2)
        g[2, :2] = [rng.uniform(-1, 1) * spec["max_persp"] / w,
                    rng.uniform(-1, 1) * spec["max_persp"] / h]
        ginv = np.linalg.inv(g)
        pts = np.concatenate([corners(np.eye(3), h, w), corners(ginv, h, w)])
        lo, hi = pts.min(0), pts.max(0)
        room = np.array([cw - 1, ch - 1]) - (hi - lo)
        if room.min() < 0:
            raise ValueError(f"a pair needs {hi - lo} px, more than the {cw}x{ch} canvas")
        place = np.eye(3)
        place[:2, 2] = rng.uniform(0, 1, 2) * room - lo
        maps_a.append(place)
        maps_b.append(place @ ginv)
        truths.append(g)
    return maps_a, maps_b, truths


def render(canvas: torch.Tensor, maps: list[np.ndarray], h: int, w: int) -> torch.Tensor:
    """(len(maps), h, w) float32 views: the canvas sampled bilinearly at
    each map's image of the frame's pixels. Raises if a view leaves the
    canvas."""
    ch, cw = canvas.shape
    dev = canvas.device
    for m in maps:
        c = corners(m, h, w)
        if c.min() < 0 or c[:, 0].max() > cw - 1 or c[:, 1].max() > ch - 1:
            raise ValueError(f"a view leaves the {cw}x{ch} canvas: corners {c.tolist()}")
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                            torch.arange(w, device=dev, dtype=torch.float64), indexing="ij")
    flat = canvas.reshape(-1)
    out = torch.empty((len(maps), h, w), dtype=torch.float32, device=dev)
    for i, m in enumerate(maps):
        mt = torch.as_tensor(m, device=dev)
        den = mt[2, 0] * xs + mt[2, 1] * ys + mt[2, 2]
        sx = ((mt[0, 0] * xs + mt[0, 1] * ys + mt[0, 2]) / den).clamp(0, cw - 1)
        sy = ((mt[1, 0] * xs + mt[1, 1] * ys + mt[1, 2]) / den).clamp(0, ch - 1)
        x0 = torch.floor(sx).clamp(max=cw - 2)
        y0 = torch.floor(sy).clamp(max=ch - 2)
        fx = (sx - x0).to(torch.float32)
        fy = (sy - y0).to(torch.float32)
        i0 = y0.to(torch.int64) * cw + x0.to(torch.int64)
        top = flat[i0] * (1 - fx) + flat[i0 + 1] * fx
        bot = flat[i0 + cw] * (1 - fx) + flat[i0 + cw + 1] * fx
        out[i] = top * (1 - fy) + bot * fy
    return out


class Views:
    """The frames of one run: ``frames`` (N, h, w) on the device, and for
    pairs the index of each pair's views and its true homography A -> B."""

    def __init__(self, spec: dict, h: int, w: int, seed: int, device: torch.device):
        scale = float(spec.get("canvas_scale", 2.0))
        ch, cw = int(round(h * scale)), int(round(w * scale))
        canvas = paint_canvas(ch, cw, int(spec["scene_seed"]), device)
        self.kind = spec["kind"]
        if self.kind == "path":
            maps = path_maps(spec, h, w, ch, cw, seed)
            self.truths = None
        elif self.kind == "pairs":
            maps_a, maps_b, self.truths = pair_maps(spec, h, w, ch, cw, seed)
            maps = [m for ab in zip(maps_a, maps_b) for m in ab]
        else:
            raise ValueError(f"unknown kind of views {self.kind!r}")
        self.frames = render(canvas, maps, h, w)
        del canvas

    def __len__(self) -> int:
        return self.frames.shape[0]
