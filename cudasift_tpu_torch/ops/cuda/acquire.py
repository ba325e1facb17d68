"""P1 wrappers: per-keypoint patch acquisition, the patch-acquisition
microbenchmark.

Replaces the TPU kernels of ``benchmarks/acquire_bench.py``:
``make_hbm_variant`` (each keypoint's aligned (56, 256) patch copied by
async DMA) and ``make_vmem_variant`` (the image resident in VMEM), each with
and without the realignment by two dynamic rolls. The CUDA kernels
(``csrc/acquire.cu``) are the *staged* one, each window copied global ->
shared by the Tensor Memory Accelerator (a tensor map over the image, one
``cp.async.bulk.tensor`` box a piece, an ``mbarrier`` a slot), and the
*direct* one, the window read straight from global memory in aligned
16-byte words; each with and without the rolls, four launchers in all.
Bound by bytes. A window is cut into at most four pieces where it wraps;
a piece that leaves the image, or every piece of an image TMA cannot
address, takes the kernels' clamped branch (``window_boxes`` restates that
choice). Their plain version is ``acquire_plain`` below, which CPU tensors
take; ``acquire_bench`` runs the four variants on the benchmark's own
inputs (``bench_inputs``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...utils.build import Kernel, check, ptr
from ...utils.synth import make_test_image

GROUP = 8               # keypoints per output block
PR, PWR = 56, 256       # the aligned patch
P, PW = 48, 64          # the summed window
HALF = 65536            # rx of keypoint i sits at rxy[i + HALF] in the bench

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _kernel(symbol: str, line: int, extra: tuple = ()) -> Kernel:
    return Kernel("acquire.cu", symbol, list(_ARGS) + list(extra), name=symbol,
                  replaces=f"benchmarks/acquire_bench.py:{line}")


# (staged, roll) -> kernel; the TPU's pallas_call lines of make_hbm_variant
# (staged) and make_vmem_variant (direct). The staged launchers take one
# more pointer, the optional count of boxes that arrived by TMA.
KERNELS = {
    (True, False): _kernel("acquire_staged", 73, (ctypes.c_void_p,)),
    (True, True): _kernel("acquire_staged_roll", 73, (ctypes.c_void_p,)),
    (False, False): _kernel("acquire_direct", 112),
    (False, True): _kernel("acquire_direct_roll", 112),
}


def window_index(oy, ox, rxy, roll: bool, h: int, w: int):
    """(n, 48, 1) rows and (n, 1, 64) columns of every keypoint's window,
    clamped to the image."""
    n = oy.shape[0]
    dev = oy.device
    r = torch.arange(P, device=dev)[None]
    c = torch.arange(PW, device=dev)[None]
    if roll:
        half = rxy.shape[0] // 2
        r = (r + rxy[:n, None]) % PR
        c = (c + rxy[half:half + n, None]) % PWR
    rows = torch.clamp(oy.long()[:, None] + r, 0, h - 1)
    cols = torch.clamp(ox.long()[:, None] + c, 0, w - 1)
    return rows[:, :, None], cols[:, None, :]


class Box(NamedTuple):
    """One piece of a window: its first pixel (y, x) in the image, its size,
    and whether the staged kernel loads it by TMA (else by its clamped
    branch)."""

    y: int
    x: int
    rows: int
    cols: int
    tma: bool


def window_boxes(oy, ox, rxy, roll: bool, h: int, w: int, base_aligned: bool = True):
    """The pieces the staged kernel cuts each keypoint's window into, as
    ``csrc/acquire.cu::piece`` cuts them: rows where r + ry reaches 56,
    columns where c + rx reaches 256, so one to four ``Box`` es a keypoint.
    A box goes by TMA when it lies inside the (h, w) image and the image is
    one TMA can address: a row pitch on 16 bytes (w % 4 == 0), a base on 16
    bytes (``base_aligned``) and at least one TMA box in size, 48 rows of 68
    columns (the kernel's box starts at the 16-byte word that holds the
    piece's first column, so it spans up to 4 more). Takes
    numpy arrays or tensors; returns one list of boxes per keypoint. Used by
    the tests and ``chip_smoke.py``, not by any path: what the kernel
    decided on the card, ``acquire``'s ``tma_pieces`` counts."""
    oy, ox, rxy = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in (oy, ox, rxy))
    n = oy.shape[0]
    half = rxy.shape[0] // 2
    tma_ok = w % 4 == 0 and base_aligned and h >= P and w >= PW + 4
    out = []
    for i in range(n):
        ry = int(rxy[i]) % PR if roll else 0
        rx = int(rxy[i + half]) % PWR if roll else 0
        r1, c1 = min(P, PR - ry), min(PW, PWR - rx)
        boxes = []
        for y, rows in ((int(oy[i]) + ry, r1), (int(oy[i]), P - r1)):
            for x, cols in ((int(ox[i]) + rx, c1), (int(ox[i]), PW - c1)):
                if rows and cols:
                    inside = y >= 0 and y + rows <= h and x >= 0 and x + cols <= w
                    boxes.append(Box(y, x, rows, cols, tma_ok and inside))
        out.append(boxes)
    return out


def acquire_plain(img, oy, ox, rxy, roll: bool):
    """Plain PyTorch version of ``acquire`` (any device)."""
    n = oy.shape[0]
    h, w = img.shape
    rows, cols = window_index(oy, ox, rxy, roll, h, w)
    sums = img[rows, cols].sum(dim=(1, 2)).reshape(n // GROUP, GROUP).sum(dim=1)
    out = torch.zeros((n // GROUP, 8, 128), dtype=torch.float32, device=img.device)
    out[:, 0, :] = sums[:, None]
    return out


def acquire(img: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, rxy: torch.Tensor,
            staged: bool = True, roll: bool = False,
            tma_pieces: torch.Tensor | None = None) -> torch.Tensor:
    """Per group of 8 keypoints, the sum of their (48, 64) window sums.

    ``img`` (H, W) f32; ``oy``/``ox`` (n,) int32 patch origins, n a
    multiple of 8; ``rxy`` (2 * half,) int32 with keypoint i's row and column
    realignment at ``rxy[i]`` and ``rxy[i + half]`` (read only with
    ``roll``; n <= half). The window of keypoint i is ``img[oy + (r + ry) %
    56, ox + (c + rx) % 256]`` for r < 48, c < 64, reads clamped to the
    image. Returns (n / 8, 8, 128) f32: row 0 of each block holds its sum in
    every lane, rows 1-7 zeros. ``staged`` picks the TMA kernel over the
    direct one on CUDA tensors; the staged launcher encodes the image's
    tensor map on every call and raises if the driver refuses it. Given
    ``tma_pieces``, a (1,) int32 tensor on the card, the staged kernel adds
    to it the number of window pieces that arrived by TMA (the CPU's plain
    version and the direct kernel load none, and leave it as it is).
    """
    n = oy.shape[0]
    if n % GROUP:
        raise ValueError(f"the keypoint count must be a multiple of {GROUP}, got {n}")
    if roll and n > rxy.shape[0] // 2:
        raise ValueError(f"rxy holds {rxy.shape[0] // 2} realignments, {n} keypoints need them")
    if img.device.type == "cpu":
        return acquire_plain(img, oy, ox, rxy, roll)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {tuple(img.shape)}")
    h, w = img.shape
    dev = img.device
    check(img, "img", torch.float32, (h, w), dev)
    check(oy, "oy", torch.int32, (n,), dev)
    check(ox, "ox", torch.int32, (n,), dev)
    check(rxy, "rxy", torch.int32, (rxy.shape[0],), dev)
    extra = ()
    if staged:
        if tma_pieces is not None:
            check(tma_pieces, "tma_pieces", torch.int32, (1,), dev)
        extra = (None if tma_pieces is None else ptr(tma_pieces),)
    out = torch.empty((n // GROUP, 8, 128), dtype=torch.float32, device=dev)
    KERNELS[(staged, roll)](dev, ptr(img), h, w, ptr(oy), ptr(ox), ptr(rxy), rxy.shape[0] // 2, n,
                            ptr(out), *extra)
    return out


def bench_inputs(n: int = 2048, h: int = 1080, w: int = 1920, seed: int = 0):
    """The benchmark's inputs (``acquire_bench.py:124-136``) as numpy: an
    (h + 56, w + 256) frame (``synth.make_test_image``), patch origins at
    multiples of 8 rows and 128 columns that keep the patch inside it, and
    realignments ry < 8, rx < 128 at ``rxy[i]`` and ``rxy[i + 65536]``.
    Returns (img, oy, ox, rxy)."""
    rng = np.random.default_rng(seed)
    img = make_test_image(h + PR, w + PWR, seed)
    ih, iw = img.shape
    oy = (rng.integers(0, (ih - PR) // 8, n) * 8).astype(np.int32)
    ox = (rng.integers(0, (iw - PWR) // 128, n) * 128).astype(np.int32)
    rxy = np.concatenate([rng.integers(0, 8, HALF), rng.integers(0, 128, HALF)]).astype(np.int32)
    return img, oy, ox, rxy


VARIANTS = (("staged", True, False), ("staged + rolls", True, True),
            ("direct", False, False), ("direct + rolls", False, True))


def acquire_bench(img, oy, ox, rxy) -> dict:
    """Run the four variants once each on tensors of one device; returns
    {variant name: (n / 8, 8, 128) result}."""
    return {name: acquire(img, oy, ox, rxy, staged, roll) for name, staged, roll in VARIANTS}
