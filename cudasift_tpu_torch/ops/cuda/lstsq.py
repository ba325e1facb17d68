"""The weighted 8-parameter refit of the homography programs as one
hand-written kernel: RANSAC's four LO refits take it.

Replaces no TPU kernel: it stands beside the XLA refit of the JAX package
(``cudasift_tpu/ops/linalg.py``, ``weighted_lstsq8``, a float32 thin QR),
which has no Pallas kernel. The CUDA kernel (``csrc/lstsq8.cu``) runs the
same QR, modified Gram-Schmidt with a second pass, over the live rows of
each weighting on a cluster of eight blocks, one launch a call where the
plain PyTorch QR runs some 460. One call of the wrapper counts as one
launch of ``KERNEL``. Its plain twin is ``ops.linalg.weighted_lstsq8``
(``weighted_lstsq8_plain`` here), which CPU tensors take; the two differ
only in the order of each dot product's sum.
"""

from __future__ import annotations

import ctypes

import torch

from ..linalg import weighted_lstsq8 as weighted_lstsq8_plain
from ...utils.build import Kernel, check, ptr

KERNEL = Kernel(
    "lstsq8.cu", "weighted_lstsq8",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p],
    replaces="cudasift_tpu/ops/linalg.py:58",
)


def weighted_lstsq8(ya: torch.Tensor, yb: torch.Tensor, w: torch.Tensor, bx: torch.Tensor,
                    by: torch.Tensor, num_pts: torch.Tensor):
    """B weighted 8-parameter least-squares solves of the same DLT rows.

    ``ya``, ``yb`` (n, 8), ``w`` (B, n), ``bx``, ``by`` (n,) float32;
    ``num_pts`` a 0-d int32 tensor of the live rows (rows at or past it are
    left out; every caller's weight is 0 there). Returns (a (B, 8) float32,
    ok (B,) bool); see ``weighted_lstsq8_plain``.
    """
    if ya.device.type == "cpu":
        return weighted_lstsq8_plain(ya, yb, w, bx, by, num_pts)
    dev = ya.device
    n, num_w = ya.shape[0], w.shape[0]
    check(ya, "ya", torch.float32, (n, 8), dev)
    check(yb, "yb", torch.float32, (n, 8), dev)
    check(w, "w", torch.float32, (num_w, n), dev)
    check(bx, "bx", torch.float32, (n,), dev)
    check(by, "by", torch.float32, (n,), dev)
    check(num_pts, "num_pts", torch.int32, (), dev)
    for name, rows in (("ya", ya), ("yb", yb)):
        if rows.data_ptr() % 16:
            raise ValueError(f"{name} does not start on 16 bytes (the kernel reads rows "
                             f"as two 16-byte words)")
    work = torch.empty((num_w, 9, 2 * n), dtype=torch.float32, device=dev)
    a = torch.empty((num_w, 8), dtype=torch.float32, device=dev)
    ok = torch.empty((num_w,), dtype=torch.bool, device=dev)
    KERNEL(dev, ptr(ya), ptr(yb), ptr(w), ptr(bx), ptr(by), n, num_w, ptr(num_pts),
           ptr(work), ptr(a), ptr(ok))
    return a, ok
