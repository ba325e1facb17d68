"""RANSAC's hypothesis scoring as one hand-written kernel.

Replaces no TPU kernel: it stands beside the XLA scoring of the JAX
package (``cudasift_tpu/ops/homography.py``, ``_inlier_counts``), which has
no Pallas kernel. The CUDA kernel (``csrc/ransac_score.cu``) keeps each
thread's hypotheses in registers, stages the live points in shared memory
16 bytes a point, stops at the live count it reads on the device and writes
nothing but per-block partials, which a second small launch sums in a fixed
order; one call of the wrapper counts as one launch of ``SCORE_KERNEL``.
Every term and count equals the plain version's bit for bit; the MSAC sums
differ only in their order of summation. Its plain version is
``inlier_counts_plain``, which CPU tensors take.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.build import Kernel, check, ptr

SCORE_KERNEL = Kernel(
    "ransac_score.cu", "ransac_score",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    flags=("-fmad=false",),
    replaces="cudasift_tpu/ops/homography.py:86",
)
# Points a block of the kernel scores (``TILE_P`` in csrc/ransac_score.cu):
# the point fields are cut into this many splits.
POINT_SPLIT = 256
# The kernel's grid has one row of blocks a split (CUDA's grid y is 16 bits).
MAX_SPLITS = 65535

# Candidate homographies the plain version scores per chunk: bounds its
# (chunk, max_pts) temporaries to a few hundred MB at max_pts = 32768.
_SCORE_CHUNK = 1024


def inlier_counts_plain(h8, x1, y1, x2, y2, num_pts, thresh):
    """Plain PyTorch version of ``inlier_counts`` (any device)."""
    valid = torch.arange(x1.shape[0], device=x1.device) < num_pts
    x1, y1, x2, y2 = x1[None, :], y1[None, :], x2[None, :], y2[None, :]
    counts, msacs = [], []
    t2 = thresh * thresh
    for c0 in range(0, h8.shape[0], _SCORE_CHUNK):
        h = h8[c0:c0 + _SCORE_CHUNK]
        nomx = h[:, 0:1] * x1 + h[:, 1:2] * y1 + h[:, 2:3]
        nomy = h[:, 3:4] * x1 + h[:, 4:5] * y1 + h[:, 5:6]
        deno = h[:, 6:7] * x1 + h[:, 7:8] * y1 + 1.0
        err2s = (x2 * deno - nomx) ** 2 + (y2 * deno - nomy) ** 2
        ok = (err2s < t2 * deno * deno) & valid[None, :]
        deno2 = torch.clamp(deno * deno, min=1e-12)
        err2 = torch.clamp(err2s / deno2, max=t2)
        msacs.append(torch.where(valid[None, :], err2, 0.0).sum(dim=1))
        counts.append(ok.sum(dim=1))
    return torch.cat(counts), torch.cat(msacs)


def inlier_counts(h8: torch.Tensor, x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
                  y2: torch.Tensor, num_pts: torch.Tensor, thresh: torch.Tensor):
    """Inlier count (the reference's division-free test, matching.cu:969-981)
    and MSAC score ``sum(min(err^2, thresh^2))`` of each row of ``h8``.

    ``h8`` (L, 8) f32 rows [h00..h21] (h22 = 1), the point fields (max_pts,)
    f32, ``num_pts`` () int32 and ``thresh`` () f32; only points below
    ``num_pts`` count. Returns (counts (L,) int64, msac (L,) f32).
    """
    if h8.device.type == "cpu":
        return inlier_counts_plain(h8, x1, y1, x2, y2, num_pts, thresh)
    dev = h8.device
    num_h, max_pts = h8.shape[0], x1.shape[0]
    check(h8, "h8", torch.float32, (num_h, 8), dev)
    for name, f in (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2)):
        check(f, name, torch.float32, (max_pts,), dev)
    check(num_pts, "num_pts", torch.int32, (), dev)
    check(thresh, "thresh", torch.float32, (), dev)
    splits = -(-max_pts // POINT_SPLIT)
    if splits > MAX_SPLITS:
        raise ValueError(f"{max_pts} points are past the kernel's grid "
                         f"({MAX_SPLITS} splits of {POINT_SPLIT})")
    part_count = torch.empty((splits, num_h), dtype=torch.int32, device=dev)
    part_msac = torch.empty((splits, num_h), dtype=torch.float32, device=dev)
    counts = torch.empty((num_h,), dtype=torch.int64, device=dev)
    msac = torch.empty((num_h,), dtype=torch.float32, device=dev)
    SCORE_KERNEL(dev, ptr(h8), num_h, ptr(x1), ptr(y1), ptr(x2), ptr(y2), max_pts,
                 ptr(num_pts), ptr(thresh), ptr(part_count), ptr(part_msac), ptr(counts),
                 ptr(msac))
    return counts, msac
