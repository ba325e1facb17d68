"""Small batched dense solves.

``solve_batched`` is an unrolled Gauss-Jordan elimination with partial
pivoting for the RANSAC 8x8 DLT systems (the reference inverts them per
thread, matching.cu:821-905). ``weighted_lstsq8`` solves the weighted
8-parameter least-squares refits by thin QR: float32 normal equations
square the condition number and lose the homography's perspective row
(the reference survives only through float64 cv::solve, geomFuncs.cpp:55).
It is the plain twin of the CUDA kernel ``csrc/lstsq8.cu``
(``ops.cuda.lstsq``), the same QR step for step.
"""

from __future__ import annotations

import torch


def solve_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a[i] @ x[i] = b[i]``; a (..., n, n), b (..., n).

    Singular systems yield inf/nan, which callers mask out.
    """
    n = a.shape[-1]
    aug = torch.cat([a, b[..., None]], dim=-1)               # (..., n, n+1)
    row_idx = torch.arange(n, device=a.device)
    for k in range(n):
        col = aug[..., :, k].abs()
        col = torch.where(row_idx >= k, col, -torch.inf)
        piv = torch.argmax(col, dim=-1)                      # (...,)
        pivot_row = torch.gather(
            aug, -2, piv[..., None, None].expand(*piv.shape, 1, n + 1))
        k_row = aug[..., k:k + 1, :]
        onehot_piv = (row_idx[:, None] == piv[..., None, None]).to(aug.dtype)
        onehot_k = (row_idx[:, None] == k).to(aug.dtype)
        aug = (aug + onehot_k * (pivot_row - k_row)
               + onehot_piv * (k_row - pivot_row))
        pivot = aug[..., k:k + 1, k:k + 1]
        pivot = torch.where(pivot.abs() < 1e-30, 1e-30, pivot)
        factors = aug[..., :, k:k + 1] / pivot
        factors = torch.where(row_idx[:, None] == k, 0.0, factors)
        aug = aug - factors * aug[..., k:k + 1, :]
        aug = torch.where((row_idx == k)[:, None], aug / pivot, aug)
    return aug[..., :, n]


def weighted_lstsq8(ya, yb, w, bx, by, num_pts=None):
    """Weighted least squares for the 8-parameter DLT rows, by thin QR.

    Minimizes ``||sqrt(w) (Y a - b)||`` where Y stacks ``ya`` and ``yb``
    (each (n, 8)) and b stacks ``bx``/``by`` (each (n,)). ``w`` is (B, n):
    B weightings of the same rows solved together. Rows at or past
    ``num_pts`` (a 0-d tensor; None: every row) are left out. Modified
    Gram-Schmidt with one re-orthogonalization pass. Returns (a (B, 8),
    ok (B,)) where ok requires >= 4 weighted rows and a numerically
    nonsingular R.
    """
    if num_pts is not None:
        live = torch.arange(ya.shape[0], device=ya.device) < num_pts
        ya, yb = (torch.where(live[:, None], y, 0.0) for y in (ya, yb))
        bx, by = (torch.where(live, y, 0.0) for y in (bx, by))
        w = torch.where(live, w, 0.0)
    sw = torch.sqrt(w)                                       # (B, n)
    a_mat = torch.cat([ya[None] * sw[..., None], yb[None] * sw[..., None]], dim=1)
    b = torch.cat([sw * bx, sw * by], dim=1)                 # (B, 2n)

    qs = []
    r = [[None] * 8 for _ in range(8)]
    qtb = []
    ok = w.sum(dim=1) >= 4.0
    for j in range(8):
        v = a_mat[:, :, j]
        acc = [torch.zeros_like(ok, dtype=w.dtype) for _ in range(j)]
        for _pass in range(2):
            for i in range(j):
                cij = (qs[i] * v).sum(dim=1)
                acc[i] = acc[i] + cij
                v = v - cij[:, None] * qs[i]
        for i in range(j):
            r[i][j] = acc[i]
        nj = torch.sqrt((v * v).sum(dim=1))
        ok = ok & (nj > 1e-12)
        q = v / torch.clamp(nj, min=1e-30)[:, None]
        r[j][j] = nj
        qtb.append((q * b).sum(dim=1))
        qs.append(q)

    a = [None] * 8
    for j in range(7, -1, -1):
        s = qtb[j]
        if j < 7:
            s = s - torch.stack([r[j][m] * a[m] for m in range(j + 1, 8)], dim=1).sum(dim=1)
        a[j] = s / torch.clamp(r[j][j], min=1e-30)
    a = torch.stack(a, dim=1)
    ok = ok & torch.isfinite(a).all(dim=1)
    return a, ok
