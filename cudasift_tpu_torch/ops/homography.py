"""RANSAC homography estimation and iterative least-squares refinement
(FindHomography, matching.cu:1000-1087; ImproveHomography,
geomFuncs.cpp:6-72), on device tensors end to end.

``find_homography`` draws 4-point samples from a ``torch.Generator``,
solves Hartley-normalized 8x8 DLT systems in a batch, scores every
candidate by MSAC (ties in the inlier count go to the sharper consensus;
on the card one hand-written kernel, ``ops.cuda.ransac.inlier_counts``),
and refits the winner on its own inlier set (LO-RANSAC, 4 passes).
``improve_homography`` runs iteratively reweighted least squares and picks,
each iteration, among four supports by MSAC at 0.75*thresh. All refits go
through the thin QR of ``ops.linalg``: RANSAC's, on the card, as one
hand-written kernel over the live matches (``ops.cuda.lstsq``). IRLS's stay
plain PyTorch on the card too: its MSAC choice between near-equal supports
and its numFit turn on the float32 rounding of each sum, and the kernel
sums in another order, so IRLS on it leaves the benchmark reference's
``irls.num_fit`` by one or two points in some runs.

Each is one program, as the JAX module is one jitted program: on CUDA
tensors the bodies ``_find_homography_jit`` and ``_improve_homography_jit``
replay one captured CUDA graph per (shapes, IRLS's loop count, device)
(``utils.jit.cuda_graph_jit``). The matched points' fields and the
thresholds are copied in. RANSAC's uniform draws are made outside the
program, from the caller's generator, and copied in too, so a replay takes
fresh draws and a call gives the same numbers replayed or eager. Nothing
inside reads a tensor on the host or copies host data to the card.

With ``utils.trace`` on, RANSAC's body marks three stages: ``ransac.sample``
(the good set, quads, normalisation, DLT and denormalisation),
``ransac.score`` (every hypothesis scored) and ``ransac.refit`` (the winner,
the four LO passes, the rescore and the final select); the draws are the
host span ``ransac.draws``.
"""

from __future__ import annotations

import torch

from ..config import HomographyParams
from ..sift_data import SiftData
from .cuda.lstsq import weighted_lstsq8
from .cuda.ransac import inlier_counts
from .detect import rank_select
from ..utils import trace
from ..utils.jit import cuda_graph_jit
from . import linalg
from .linalg import solve_batched


def _distinct_quads(u: torch.Tensor, num_valid: torch.Tensor) -> torch.Tensor:
    """(L, 4) distinct indices in [0, max(num_valid, 8)) from (L, 4) uniform
    draws in [0, 1): colliding draws are bumped forward (mod n) in 4 passes,
    which makes every quad distinct for n >= 8 (the caller requires
    num_valid >= 8, matching.cu:1040)."""
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


def _uniform_draws(generator: torch.Generator | None, num_loops: int,
                   device: torch.device) -> torch.Tensor:
    """(num_loops, 4) uniform draws in [0, 1) from ``generator`` (the CPU
    default generator when None), made on the generator's device and copied
    to ``device``; ``_distinct_quads`` turns them into the samples that
    replace the host rand() rejection loops (matching.cu:1041-1053)."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    return torch.rand((num_loops, 4), generator=generator, device=gdev).to(device)


def _dlt_batch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Batched 8-parameter DLT (ComputeHomographies, matching.cu:907-948):
    src, dst (L, 4, 2) -> (L, 8) rows [h00..h21], h22 = 1."""
    x1, y1 = src[..., 0], src[..., 1]
    x2, y2 = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x1)
    ones = torch.ones_like(x1)
    rows_a = torch.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1], dim=-1)
    rows_b = torch.stack([zeros, zeros, zeros, x1, y1, ones, -y2 * x1, -y2 * y1], dim=-1)
    a = torch.cat([rows_a, rows_b], dim=1)                   # (L, 8, 8)
    b = torch.cat([x2, y2], dim=1)                           # (L, 8)
    return solve_batched(a, b)


def _normalization(x, y, mask):
    """Hartley similarity: zero mean, mean distance sqrt(2)."""
    w = mask.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    cx = (x * w).sum() / n
    cy = (y * w).sum() / n
    d = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    mean_d = (d * w).sum() / n
    s = 1.4142135623730951 / torch.clamp(mean_d, min=1e-6)
    return cx, cy, s


def _similarity(s, cx, cy, inverse: bool = False) -> torch.Tensor:
    """T = [[s, 0, -s*cx], [0, s, -s*cy], [0, 0, 1]] or its inverse."""
    one = torch.ones_like(s)
    zero = torch.zeros_like(s)
    if inverse:
        rows = [[1 / s, zero, cx], [zero, 1 / s, cy], [zero, zero, one]]
    else:
        rows = [[s, zero, -s * cx], [zero, s, -s * cy], [zero, zero, one]]
    return torch.stack([torch.stack(r) for r in rows])


def _dlt_rows(nx1, ny1, nx2, ny2):
    ones = torch.ones_like(nx1)
    zeros = torch.zeros_like(nx1)
    ya = torch.stack([nx1, ny1, ones, zeros, zeros, zeros, -nx1 * nx2, -ny1 * nx2], 1)
    yb = torch.stack([zeros, zeros, zeros, nx1, ny1, ones, -nx1 * ny2, -ny1 * ny2], 1)
    return ya, yb


def _denormalize(a8, t2inv, t1):
    """(B, 8) normalized solutions -> (B, 3, 3) pixel homographies, h22 = 1."""
    hn = torch.cat([a8, torch.ones_like(a8[:, :1])], dim=1).reshape(-1, 3, 3)
    hr = t2inv @ hn @ t1
    h22 = hr[:, 2, 2]
    h22 = torch.where(h22.abs() < 1e-12, 1e-12, h22)
    return hr / h22[:, None, None]


def find_homography(
    data: SiftData,
    generator: torch.Generator | None = None,
    num_loops: int | None = None,
    min_score: float | None = None,
    max_ambiguity: float | None = None,
    thresh: float | None = None,
    params: HomographyParams | None = None,
):
    """RANSAC over matched pairs. Returns (homography (3, 3), num_matches ()).

    Sample pairs are filtered by score/ambiguity (matching.cu:1034-1037);
    inliers are counted over all matched points. With fewer than 8 filtered
    pairs the identity comes back with zero matches. ``params`` supplies the
    defaults of the scalar knobs; explicit keyword arguments win.
    """
    p = params if params is not None else HomographyParams()
    num_loops = p.num_loops if num_loops is None else num_loops
    min_score = p.min_score if min_score is None else min_score
    max_ambiguity = p.max_ambiguity if max_ambiguity is None else max_ambiguity
    thresh = p.thresh if thresh is None else thresh
    with trace.span("find_homography"):
        with trace.span("ransac.draws"):
            u = _uniform_draws(generator, int(num_loops), data.device)
        return _find_homography_jit(_pairs(data), u,
                                    _gates(min_score, max_ambiguity, thresh, data.device))


def _pairs(data: SiftData) -> tuple:
    """The fields of a matched ``SiftData`` that the two bodies read; a
    replay copies these in, not the descriptors."""
    return (data.xpos, data.ypos, data.match_xpos, data.match_ypos, data.score,
            data.ambiguity, data.num_pts)


def _gates(min_score, max_ambiguity, thresh, device: torch.device) -> tuple:
    """(min_score, max_ambiguity, thresh) as 0-d float32 tensors on
    ``device``: a program takes them as data, so another threshold replays
    the same program (the JAX package traces them too). Each is a fill on
    the device: a copy from host memory would wait for the stream."""
    return tuple(torch.full((), float(v), dtype=torch.float32, device=device)
                 for v in (min_score, max_ambiguity, thresh))


@cuda_graph_jit
def _find_homography_jit(pairs: tuple, u: torch.Tensor, gates: tuple):
    """``find_homography`` on the uniform draws ``u`` (num_loops, 4)."""
    x1, y1, x2, y2, score, ambiguity, num_pts = pairs
    min_score, max_ambiguity, thresh = gates
    dev, max_pts = x1.device, x1.shape[0]
    with trace.stage("ransac.sample", dev):
        valid_pts = torch.arange(max_pts, device=dev) < num_pts
        good = valid_pts & (score > min_score) & (ambiguity < max_ambiguity)
        good_idx, num_good, _ = rank_select(good, max_pts)

        quads = _distinct_quads(u, num_good)                  # (L, 4)
        pick = good_idx[quads]

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

    with trace.stage("ransac.score", dev):
        counts, msac = inlier_counts(h8, x1, y1, x2, y2, num_pts, thresh)
    with trace.stage("ransac.refit", dev):
        # The winner by index_select: indexing with a 0-d tensor would read it
        # on the host.
        best = torch.argmin(msac).reshape(1)
        best_h8 = h8.index_select(0, best)[0]
        num_matches = counts.index_select(0, best)[0]

        # LO-RANSAC: refit the winner on all valid matches within `thresh` of
        # it, four times (documented deviation from the raw 4-point winner the
        # reference returns, ROADMAP.md).
        ya, yb = _dlt_rows(s1 * (x1 - cx1), s1 * (y1 - cy1),
                           s2 * (x2 - cx2), s2 * (y2 - cy2))
        refit = best_h8
        for _ in range(4):
            h = torch.cat([refit, torch.ones_like(refit[:1])]).reshape(3, 3)
            den = h[2, 0] * x1 + h[2, 1] * y1 + 1.0
            den = torch.where(den.abs() < 1e-12, 1e-12, den)
            px = (h[0, 0] * x1 + h[0, 1] * y1 + h[0, 2]) / den
            py = (h[1, 0] * x1 + h[1, 1] * y1 + h[1, 2]) / den
            err2 = (px - x2) ** 2 + (py - y2) ** 2
            w = (valid_pts & (err2 < thresh * thresh)).to(torch.float32)
            a, ok = weighted_lstsq8(ya, yb, w[None], s2 * (x2 - cx2), s2 * (y2 - cy2),
                                    num_pts)
            hr8 = _denormalize(a, t2inv, t1).reshape(9)[:8]
            ok = ok[0] & torch.isfinite(hr8).all()
            refit = torch.where(ok, hr8, refit)
        refit_counts, refit_msac = inlier_counts(refit[None], x1, y1, x2, y2, num_pts,
                                                 thresh)
        better = refit_msac[0] <= msac.index_select(0, best)[0]
        best_h8 = torch.where(better, refit, best_h8)
        num_matches = torch.where(better, refit_counts[0], num_matches)

        enough = num_good >= 8
        identity = torch.eye(3, dtype=torch.float32, device=dev).reshape(9)[:8]
        best_h8 = torch.where(enough, best_h8, identity)
        num_matches = torch.where(enough, num_matches, 0).to(torch.int32)
        homography = torch.cat([best_h8, torch.ones_like(best_h8[:1])]).reshape(3, 3)
        return homography, num_matches


def improve_homography(
    data: SiftData,
    homography: torch.Tensor,
    num_loops: int = 5,
    min_score: float = 0.0,
    max_ambiguity: float = 0.95,
    thresh: float = 3.0,
):
    """Iteratively reweighted DLT refinement (ImproveHomography,
    geomFuncs.cpp:6-72) in Hartley-normalized coordinates.

    Each iteration solves three weighted refits -- the gated
    (score/ambiguity-filtered) inliers at ``thresh``, all valid inliers at
    ``thresh``, and all valid pairs within 2*thresh -- and keeps, among
    them and the current homography, the best MSAC score at 0.75*thresh.
    A refit with fewer than 4 weighted pairs is skipped.

    Returns (homography (3, 3), num_fit (), match_error (max_pts,)).
    """
    with trace.span("improve_homography"):
        return _improve_homography_jit(_pairs(data), homography, int(num_loops),
                                       _gates(min_score, max_ambiguity, thresh, data.device))


@cuda_graph_jit
def _improve_homography_jit(pairs: tuple, homography: torch.Tensor, num_loops: int,
                            gates: tuple):
    """``improve_homography``'s body."""
    x1, y1, x2, y2, score, ambiguity, num_pts = pairs
    min_score, max_ambiguity, thresh = gates
    limit = thresh * thresh
    valid = torch.arange(x1.shape[0], device=x1.device) < num_pts
    gated = valid & (score >= min_score) & (ambiguity <= max_ambiguity)

    cx1, cy1, s1 = _normalization(x1, y1, gated)
    cx2, cy2, s2 = _normalization(x2, y2, gated)
    nx2, ny2 = s2 * (x2 - cx2), s2 * (y2 - cy2)
    ya, yb = _dlt_rows(s1 * (x1 - cx1), s1 * (y1 - cy1), nx2, ny2)
    t1 = _similarity(s1, cx1, cy1)
    t2inv = _similarity(s2, cx2, cy2, inverse=True)

    def errors(h):
        """Squared reprojection errors of (..., 3, 3) homographies."""
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
        w = torch.stack([
            (gated & (err < limit)),
            (valid & (err < limit)),
            (valid & (err < 4.0 * limit)),
        ]).to(torch.float32)
        a, ok = linalg.weighted_lstsq8(ya, yb, w, nx2, ny2)
        cand = _denormalize(a, t2inv, t1)                    # (3, 3, 3)
        ok = ok & torch.isfinite(cand).flatten(1).all(dim=1)
        m = torch.where(ok, msac(errors(cand)), torch.inf)   # gated, glob, wide
        m_cur = msac(err)
        best = torch.minimum(m_cur, m.min())
        # Ties keep the gated update first, then the global, then the wide.
        h = torch.where(m[0] == best, cand[0],
                        torch.where(m[1] == best, cand[1],
                                    torch.where(m[2] == best, cand[2], h)))

    err = errors(h)
    match_error = torch.sqrt(torch.where(valid, err, 0.0))
    num_fit = (valid & (err < limit)).sum().to(torch.int32)
    return h, num_fit, match_error
