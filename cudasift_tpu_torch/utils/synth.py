"""Synthetic inputs with a known answer: a textured frame and its warp by a
known homography. Plain numpy, made from a seed; no OpenCV."""

from __future__ import annotations

import numpy as np


def make_test_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w) float32 frame of smoothed uniform noise plus 32-px blocks:
    textured enough for a realistic feature density (the synthetic branch of
    the JAX package's ``bench.make_test_image``)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    for _ in range(4):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1) + np.roll(img, -1, 0)) / 4
    blocks = rng.uniform(0, 255, (h // 32 + 1, w // 32 + 1)).astype(np.float32)
    img = 0.7 * img + 0.3 * np.kron(blocks, np.ones((32, 32), np.float32))[:h, :w]
    return img.astype(np.float32)


def make_leaves_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w) float32 dead-leaves frame: one opaque disc per 300 px of
    uniform random grey (0..255) with power-law radii from 10 to 160 px
    (density ~ r^-3), painted one over another on a mid-grey field, then
    lightly smoothed. Edges and corners at every scale make the descriptors
    distinctive, so the 0.8 ratio test has margin (``make_test_image``'s
    32-px blocks make block-corner descriptors alike), and the feature
    density stays within ``SiftParams``' default candidate capacities."""
    rng = np.random.default_rng(seed)
    rmin, rmax = 10.0, 160.0
    n = h * w // 300
    u = rng.random(n)
    r = 1.0 / np.sqrt(u * (rmin ** -2 - rmax ** -2) + rmax ** -2)
    cx = rng.uniform(-rmax, w + rmax, n)
    cy = rng.uniform(-rmax, h + rmax, n)
    grey = rng.uniform(0, 255, n).astype(np.float32)
    img = np.full((h, w), 128.0, np.float32)
    for i in range(n):
        x0, x1 = max(int(cx[i] - r[i]), 0), min(int(cx[i] + r[i]) + 1, w)
        y0, y1 = max(int(cy[i] - r[i]), 0), min(int(cy[i] + r[i]) + 1, h)
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.ogrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1][(xx - cx[i]) ** 2 + (yy - cy[i]) ** 2 <= r[i] ** 2] = grey[i]
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1) + np.roll(img, -1, 0)) / 4
    return img.astype(np.float32)


def known_homography(h: int, w: int) -> np.ndarray:
    """(3, 3) float64 homography for an (h, w) frame: a 5 degree rotation and
    0.95 scale about the frame centre, a shift of (24, -16) px and a slight
    perspective term (about 2% scale change across the frame)."""
    theta = np.deg2rad(5.0)
    s = 0.95
    a = s * np.array([[np.cos(theta), -np.sin(theta)],
                      [np.sin(theta), np.cos(theta)]])
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    t = c - a @ c + np.array([24.0, -16.0])
    hm = np.eye(3)
    hm[:2, :2] = a
    hm[:2, 2] = t
    hm[2, :2] = [0.02 / w, -0.015 / h]
    return hm


def warp_image(img: np.ndarray, hm: np.ndarray) -> np.ndarray:
    """Warp ``img`` by ``hm`` (pixel index = coordinate): the output at
    (x, y) is ``img`` bilinearly sampled at ``hm^-1 (x, y, 1)``, so a point
    p of ``img`` lands at ``hm p``. Samples outside the frame take the frame
    mean."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    src = np.linalg.inv(hm) @ np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0 = np.clip(np.floor(sx), 0, w - 2).astype(np.int64)
    y0 = np.clip(np.floor(sy), 0, h - 2).astype(np.int64)
    fx = np.clip(sx - x0, 0.0, 1.0)
    fy = np.clip(sy - y0, 0.0, 1.0)
    im = img.astype(np.float64)
    top = im[y0, x0] * (1 - fx) + im[y0, x0 + 1] * fx
    bot = im[y0 + 1, x0] * (1 - fx) + im[y0 + 1, x0 + 1] * fx
    out = np.where(inside, top * (1 - fy) + bot * fy, im.mean())
    return out.reshape(h, w).astype(np.float32)


def corner_error(h_est: np.ndarray, h_true: np.ndarray, h: int, w: int) -> float:
    """Largest distance (px) between where the two homographies map the four
    frame corners."""
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
                       np.float64).T

    def apply(m):
        p = np.asarray(m, np.float64) @ corners
        return p[:2] / p[2]

    return float(np.linalg.norm(apply(h_est) - apply(h_true), axis=0).max())
