"""The plain reference of RANSAC and of the iterative refinement of a
homography (FindHomography, matching.cu:1000-1087, with a local refit of the
winner; ImproveHomography, geomFuncs.cpp:6-72), in plain PyTorch.

A frozen copy of the measured program's plain arithmetic: RANSAC on 4-point
samples made from given uniform draws, Hartley-normalized 8x8 DLT solves by
Gauss-Jordan elimination, MSAC scoring over every valid match, then four
refits of the winner on its inliers by thin QR; the refinement reweights
three supports a loop and keeps the best MSAC at 0.75 * thresh.
"""

from __future__ import annotations

import torch

from .precision import FLOAT32, Precision
from .sift import rank_select

SCORE_CHUNK = 1024


def solve_batched(a, b):
    n = a.shape[-1]
    aug = torch.cat([a, b[..., None]], dim=-1)
    row_idx = torch.arange(n, device=a.device)
    for k in range(n):
        col = torch.where(row_idx >= k, aug[..., :, k].abs(), -torch.inf)
        piv = torch.argmax(col, dim=-1)
        pivot_row = torch.gather(aug, -2, piv[..., None, None].expand(*piv.shape, 1, n + 1))
        k_row = aug[..., k:k + 1, :]
        onehot_piv = (row_idx[:, None] == piv[..., None, None]).to(aug.dtype)
        onehot_k = (row_idx[:, None] == k).to(aug.dtype)
        aug = aug + onehot_k * (pivot_row - k_row) + onehot_piv * (k_row - pivot_row)
        pivot = aug[..., k:k + 1, k:k + 1]
        pivot = torch.where(pivot.abs() < 1e-30, 1e-30, pivot)
        factors = aug[..., :, k:k + 1] / pivot
        factors = torch.where(row_idx[:, None] == k, 0.0, factors)
        aug = aug - factors * aug[..., k:k + 1, :]
        aug = torch.where((row_idx == k)[:, None], aug / pivot, aug)
    return aug[..., :, n]


def weighted_lstsq8(ya, yb, w, bx, by):
    """Weighted 8-parameter least squares by thin QR (modified Gram-Schmidt,
    two passes); ``w`` (B, n). Returns (a (B, 8), ok (B,))."""
    sw = torch.sqrt(w)
    a_mat = torch.cat([ya[None] * sw[..., None], yb[None] * sw[..., None]], dim=1)
    b = torch.cat([sw * bx, sw * by], dim=1)
    qs, qtb = [], []
    r = [[None] * 8 for _ in range(8)]
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
    return a, ok & torch.isfinite(a).all(dim=1)


def distinct_quads(u, num_valid):
    n = torch.clamp(num_valid.to(torch.int64), min=8)
    idx = torch.remainder(torch.floor(u * n).to(torch.int64), n)
    a, b, c, d = idx.unbind(dim=1)
    for _ in range(4):
        b = torch.remainder(b + (b == a), n)
        c = torch.remainder(c + (c == a), n)
        c = torch.remainder(c + (c == b), n)
        d = torch.remainder(d + (d == a), n)
        d = torch.remainder(d + (d == b), n)
        d = torch.remainder(d + (d == c), n)
    return torch.stack([a, b, c, d], dim=1)


def _dlt_batch(src, dst):
    x1, y1 = src[..., 0], src[..., 1]
    x2, y2 = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x1), torch.ones_like(x1)
    rows_a = torch.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1], dim=-1)
    rows_b = torch.stack([zeros, zeros, zeros, x1, y1, ones, -y2 * x1, -y2 * y1], dim=-1)
    return solve_batched(torch.cat([rows_a, rows_b], dim=1), torch.cat([x2, y2], dim=1))


def _inlier_counts(h8, x1, y1, x2, y2, valid, thresh):
    counts, msacs = [], []
    t2 = thresh * thresh
    for c0 in range(0, h8.shape[0], SCORE_CHUNK):
        h = h8[c0:c0 + SCORE_CHUNK]
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


def _normalization(x, y, mask):
    w = mask.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    cx = (x * w).sum() / n
    cy = (y * w).sum() / n
    d = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    s = 1.4142135623730951 / torch.clamp((d * w).sum() / n, min=1e-6)
    return cx, cy, s


def _similarity(s, cx, cy, inverse=False):
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    if inverse:
        rows = [[1 / s, zero, cx], [zero, 1 / s, cy], [zero, zero, one]]
    else:
        rows = [[s, zero, -s * cx], [zero, s, -s * cy], [zero, zero, one]]
    return torch.stack([torch.stack(r) for r in rows])


def _dlt_rows(nx1, ny1, nx2, ny2):
    ones, zeros = torch.ones_like(nx1), torch.zeros_like(nx1)
    ya = torch.stack([nx1, ny1, ones, zeros, zeros, zeros, -nx1 * nx2, -ny1 * nx2], 1)
    yb = torch.stack([zeros, zeros, zeros, nx1, ny1, ones, -nx1 * ny2, -ny1 * ny2], 1)
    return ya, yb


def _denormalize(a8, t2inv, t1):
    hn = torch.cat([a8, torch.ones_like(a8[:, :1])], dim=1).reshape(-1, 3, 3)
    hr = t2inv @ hn @ t1
    h22 = hr[:, 2, 2]
    h22 = torch.where(h22.abs() < 1e-12, 1e-12, h22)
    return hr / h22[:, None, None]


def _points(data, prec: Precision):
    return (prec.operand(data.xpos), prec.operand(data.ypos),
            prec.operand(data.match_xpos), prec.operand(data.match_ypos))


def find_homography(data, u: torch.Tensor, min_score: float, max_ambiguity: float,
                    thresh: float, prec: Precision = FLOAT32):
    """RANSAC over the matched points of ``data`` with the (num_loops, 4)
    uniform draws ``u``. Returns (homography (3, 3), num_matches ())."""
    with prec.products():
        return _find(data, u, min_score, max_ambiguity, thresh, prec)


def _find(data, u, min_score, max_ambiguity, thresh, prec):
    x1, y1, x2, y2 = _points(data, prec)
    dev, max_pts = x1.device, x1.shape[0]
    valid_pts = torch.arange(max_pts, device=dev) < data.num_pts
    good = valid_pts & (data.score > min_score) & (data.ambiguity < max_ambiguity)
    good_idx, num_good, _ = rank_select(good, max_pts)
    pick = good_idx[distinct_quads(u, num_good)]
    cx1, cy1, s1 = _normalization(x1, y1, good)
    cx2, cy2, s2 = _normalization(x2, y2, good)
    src = torch.stack([s1 * (x1[pick] - cx1), s1 * (y1[pick] - cy1)], dim=-1)
    dst = torch.stack([s2 * (x2[pick] - cx2), s2 * (y2[pick] - cy2)], dim=-1)
    hn8 = _dlt_batch(src, dst)
    hn8 = torch.where(torch.isfinite(hn8), hn8, 0.0)
    t1 = _similarity(s1, cx1, cy1)
    t2inv = _similarity(s2, cx2, cy2, inverse=True)
    h8 = _denormalize(hn8, t2inv, t1).reshape(-1, 9)[:, :8]
    h8 = torch.where(torch.isfinite(h8), h8, 0.0)
    counts, msac = _inlier_counts(h8, x1[None, :], y1[None, :], x2[None, :], y2[None, :],
                                  valid_pts, thresh)
    best = torch.argmin(msac).reshape(1)
    best_h8 = h8.index_select(0, best)[0]
    num_matches = counts.index_select(0, best)[0]
    ya, yb = _dlt_rows(s1 * (x1 - cx1), s1 * (y1 - cy1), s2 * (x2 - cx2), s2 * (y2 - cy2))
    refit = best_h8
    for _ in range(4):
        h = torch.cat([refit, torch.ones_like(refit[:1])]).reshape(3, 3)
        den = h[2, 0] * x1 + h[2, 1] * y1 + 1.0
        den = torch.where(den.abs() < 1e-12, 1e-12, den)
        px = (h[0, 0] * x1 + h[0, 1] * y1 + h[0, 2]) / den
        py = (h[1, 0] * x1 + h[1, 1] * y1 + h[1, 2]) / den
        err2 = (px - x2) ** 2 + (py - y2) ** 2
        w = (valid_pts & (err2 < thresh * thresh)).to(torch.float32)
        a, ok = weighted_lstsq8(ya, yb, w[None], s2 * (x2 - cx2), s2 * (y2 - cy2))
        hr8 = _denormalize(a, t2inv, t1).reshape(9)[:8]
        ok = ok[0] & torch.isfinite(hr8).all()
        refit = torch.where(ok, hr8, refit)
    refit_counts, refit_msac = _inlier_counts(refit[None], x1[None, :], y1[None, :],
                                              x2[None, :], y2[None, :], valid_pts, thresh)
    better = refit_msac[0] <= msac.index_select(0, best)[0]
    best_h8 = torch.where(better, refit, best_h8)
    num_matches = torch.where(better, refit_counts[0], num_matches)
    enough = num_good >= 8
    identity = torch.eye(3, dtype=torch.float32, device=dev).reshape(9)[:8]
    best_h8 = torch.where(enough, best_h8, identity)
    num_matches = torch.where(enough, num_matches, 0).to(torch.int32)
    return torch.cat([best_h8, torch.ones_like(best_h8[:1])]).reshape(3, 3), num_matches


def improve_homography(data, homography: torch.Tensor, num_loops: int, min_score: float,
                       max_ambiguity: float, thresh: float, prec: Precision = FLOAT32):
    """Iteratively reweighted refits of ``homography``. Returns
    (homography (3, 3), num_fit (), match_error (max_pts,))."""
    with prec.products():
        return _improve(data, prec.operand(homography), num_loops, min_score,
                        max_ambiguity, thresh, prec)


def _improve(data, homography, num_loops, min_score, max_ambiguity, thresh, prec):
    x1, y1, x2, y2 = _points(data, prec)
    limit = thresh * thresh
    valid = torch.arange(x1.shape[0], device=x1.device) < data.num_pts
    gated = valid & (data.score >= min_score) & (data.ambiguity <= max_ambiguity)
    cx1, cy1, s1 = _normalization(x1, y1, gated)
    cx2, cy2, s2 = _normalization(x2, y2, gated)
    nx2, ny2 = s2 * (x2 - cx2), s2 * (y2 - cy2)
    ya, yb = _dlt_rows(s1 * (x1 - cx1), s1 * (y1 - cy1), nx2, ny2)
    t1 = _similarity(s1, cx1, cy1)
    t2inv = _similarity(s2, cx2, cy2, inverse=True)

    def errors(h):
        h = h[..., None]
        den = h[..., 2, 0, :] * x1 + h[..., 2, 1, :] * y1 + h[..., 2, 2, :]
        den = torch.where(den.abs() < 1e-12, 1e-12, den)
        px = (h[..., 0, 0, :] * x1 + h[..., 0, 1, :] * y1 + h[..., 0, 2, :]) / den
        py = (h[..., 1, 0, :] * x1 + h[..., 1, 1, :] * y1 + h[..., 1, 2, :]) / den
        return (px - x2) ** 2 + (py - y2) ** 2

    sub = 0.5625 * limit

    def msac(e):
        return torch.where(valid, torch.clamp(e, max=sub), 0.0).sum(dim=-1)

    h = homography / homography[2, 2]
    for _ in range(num_loops):
        err = errors(h)
        w = torch.stack([gated & (err < limit), valid & (err < limit),
                         valid & (err < 4.0 * limit)]).to(torch.float32)
        a, ok = weighted_lstsq8(ya, yb, w, nx2, ny2)
        cand = _denormalize(a, t2inv, t1)
        ok = ok & torch.isfinite(cand).flatten(1).all(dim=1)
        m = torch.where(ok, msac(errors(cand)), torch.inf)
        best = torch.minimum(msac(err), m.min())
        h = torch.where(m[0] == best, cand[0],
                        torch.where(m[1] == best, cand[1],
                                    torch.where(m[2] == best, cand[2], h)))
    err = errors(h)
    match_error = torch.sqrt(torch.where(valid, err, 0.0))
    num_fit = (valid & (err < limit)).sum().to(torch.int32)
    return h, num_fit, match_error
