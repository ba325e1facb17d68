"""The numbers that decide ``correct``: what the program produced against
what the plain reference works out from the same inputs.

Each function returns a dict of numbers, every one of them 0 when the two
sides agree and larger the more they differ. A limits file names the numbers
a cell holds to a limit (``check``); the rest are printed for calibration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Keypoints are paired across the two sides as mutual nearest neighbours
# within one octave, in a space where 1 degree of orientation weighs as much
# as 0.1 px of the octave's grid, and no farther apart than PAIR_RADIUS
# there (0.5 octave px, or 5 degrees).
ORIENTATION_WEIGHT = 0.1 / math.radians(1.0)
PAIR_RADIUS = 0.5


def _stats(name: str, v: torch.Tensor, out: dict) -> None:
    """``name``.max / .p99 / .median of the non-negative values ``v``."""
    if v.numel() == 0:
        for s in ("max", "p99", "median"):
            out[f"{name}.{s}"] = 0.0
        return
    v = v.to(torch.float64)
    out[f"{name}.max"] = float(v.max())
    out[f"{name}.p99"] = float(torch.quantile(v, 0.99)) if v.numel() > 1 else float(v[0])
    out[f"{name}.median"] = float(v.median())


def _mutual_nearest(kp: torch.Tensor, kr: torch.Tensor, block: int = 4096):
    """Index pairs (i, j) of mutual nearest rows of ``kp`` and ``kr`` no
    farther apart than PAIR_RADIUS."""
    def nearest(a, b):
        d_best = torch.empty(a.shape[0], dtype=a.dtype, device=a.device)
        i_best = torch.empty(a.shape[0], dtype=torch.int64, device=a.device)
        for r0 in range(0, a.shape[0], block):
            d = torch.cdist(a[r0:r0 + block], b)
            d_best[r0:r0 + block], i_best[r0:r0 + block] = d.min(dim=1)
        return d_best, i_best

    if kp.shape[0] == 0 or kr.shape[0] == 0:
        e = torch.empty(0, dtype=torch.int64, device=kp.device)
        return e, e
    dp, jp = nearest(kp, kr)
    _, ir = nearest(kr, kp)
    i = torch.arange(kp.shape[0], device=kp.device)
    ok = (ir[jp] == i) & (dp <= PAIR_RADIUS)
    return i[ok], jp[ok]


def _keys(pts: dict, s: float) -> torch.Tensor:
    th = torch.deg2rad(pts["orientation"].to(torch.float64))
    return torch.stack([pts["xpos"] / s, pts["ypos"] / s, ORIENTATION_WEIGHT * torch.cos(th),
                        ORIENTATION_WEIGHT * torch.sin(th)], dim=1)


def _live(d) -> dict:
    n = int(d.num_pts)
    return {k: getattr(d, k)[:n].to(torch.float64)
            for k in ("xpos", "ypos", "scale", "orientation", "subsampling", "data")}


def points(prog, ref, pairs: list | None = None) -> dict:
    """One frame's keypoints, the program's against the reference's:

    - ``count_pct``: the gap in point counts, % of the reference's;
    - ``unpaired_pct``: % of all points of either side without a partner;
    - over the pairs: ``pos_px`` (image px), ``ori_deg``, ``scale_rel`` and
      ``desc`` (the largest gap of the 128 entries), each as max, p99 and
      median.

    The index pairs (program row, reference row) are appended to ``pairs``
    when it is given.
    """
    p, r = _live(prog), _live(ref)
    n_p, n_r = p["xpos"].shape[0], r["xpos"].shape[0]
    out = {"count_pct": 100.0 * abs(n_p - n_r) / max(n_r, 1)}
    gaps = {k: [] for k in ("pos_px", "ori_deg", "scale_rel", "desc")}
    paired = 0
    levels = torch.unique(torch.cat([p["subsampling"], r["subsampling"]]))
    for s in levels.tolist():
        sp = torch.nonzero(p["subsampling"] == s).flatten()
        sr = torch.nonzero(r["subsampling"] == s).flatten()
        ps = {k: v[sp] for k, v in p.items()}
        rs = {k: v[sr] for k, v in r.items()}
        i, j = _mutual_nearest(_keys(ps, s), _keys(rs, s))
        if pairs is not None:
            pairs.append((sp[i], sr[j]))
        paired += i.numel()
        gaps["pos_px"].append(torch.hypot(ps["xpos"][i] - rs["xpos"][j],
                                          ps["ypos"][i] - rs["ypos"][j]))
        d = torch.remainder(ps["orientation"][i] - rs["orientation"][j] + 180.0, 360.0) - 180.0
        gaps["ori_deg"].append(d.abs())
        gaps["scale_rel"].append((ps["scale"][i] - rs["scale"][j]).abs()
                                 / rs["scale"][j].clamp(min=1e-12))
        gaps["desc"].append((ps["data"][i] - rs["data"][j]).abs().amax(dim=1)
                            if i.numel() else torch.empty(0, dtype=torch.float64,
                                                          device=p["data"].device))
    out["unpaired_pct"] = 100.0 * (n_p + n_r - 2 * paired) / max(n_p + n_r, 1)
    for k, v in gaps.items():
        _stats(k, torch.cat(v) if v else torch.empty(0), out)
    return out


def chain_matches(prog, ref, pairs: list) -> dict:
    """Matches that each side worked out from its own points, over the
    keypoints ``points`` paired: ``moved_pct``, % of the pairs whose matched
    point lies more than PAIR_RADIUS px apart, and the gaps of ``score``
    (max, p99, median)."""
    if not pairs:
        return {"moved_pct": 0.0, "score.max": 0.0, "score.p99": 0.0, "score.median": 0.0}
    i = torch.cat([a for a, _ in pairs])
    j = torch.cat([b for _, b in pairs])
    f64 = torch.float64
    moved = torch.hypot(prog.match_xpos[i].to(f64) - ref.match_xpos[j].to(f64),
                        prog.match_ypos[i].to(f64) - ref.match_ypos[j].to(f64))
    out = {"moved_pct": 100.0 * float((moved > PAIR_RADIUS).sum()) / max(i.numel(), 1)}
    _stats("score", (prog.score[i].to(f64) - ref.score[j].to(f64)).abs(), out)
    return out


def matches(prog, ref) -> dict:
    """Matches of one point set, the program's against the reference's from
    the same two point sets: ``index_pct`` (% of valid rows whose match
    differs), and the gaps of ``score`` and ``ambiguity`` (max, p99,
    median)."""
    n = int(ref.num_pts)
    out = {"index_pct": 100.0 * float((prog.match[:n] != ref.match[:n]).sum()) / max(n, 1)}
    _stats("score", (prog.score[:n] - ref.score[:n]).abs(), out)
    _stats("ambiguity", (prog.ambiguity[:n] - ref.ambiguity[:n]).abs(), out)
    return out


def corner_gap(h_a, h_b, h: int, w: int) -> float:
    """Largest distance (px) between where two homographies map the frame's
    four corners."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64).T

    def apply(m):
        q = np.asarray(torch.as_tensor(m).detach().cpu(), np.float64) @ c
        return q[:2] / q[2]

    gap = float(np.linalg.norm(apply(h_a) - apply(h_b), axis=0).max())
    return gap if math.isfinite(gap) else math.inf


def ransac(prog, ref, h: int, w: int) -> dict:
    """RANSAC's (homography, count), the program's against the reference's
    from the same matches and draws."""
    return {"corner_px": corner_gap(prog[0], ref[0], h, w),
            "count": float(abs(int(prog[1]) - int(ref[1])))}


def refinement(prog, ref, num_pts: int, thresh: float, h: int, w: int) -> dict:
    """The refinement's (homography, numFit, match_error), the program's
    against the reference's from the same matches and starting homography;
    ``match_error`` over the points the reference puts within 2 * thresh."""
    near = ref[2][:num_pts] < 2.0 * thresh
    gap = (prog[2][:num_pts] - ref[2][:num_pts]).abs()[near]
    return {"corner_px": corner_gap(prog[0], ref[0], h, w),
            "num_fit": float(abs(int(prog[1]) - int(ref[1]))),
            "match_error": float(gap.max()) if gap.numel() else 0.0}


def chain_homography(prog, ref, h: int, w: int) -> dict:
    """The refined (homography, numFit) that each side worked out from its
    own points, matches and RANSAC: ``corner_px`` and ``num_fit_pct`` (the
    gap in numFit, % of the reference's)."""
    return {"corner_px": corner_gap(prog[0], ref[0], h, w),
            "num_fit_pct": 100.0 * abs(int(prog[1]) - int(ref[1])) / max(int(ref[1]), 1)}


def worst(readings: list[dict]) -> dict:
    """Each number's largest value over several readings (NaN counts as
    infinite)."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            v = math.inf if v != v else v
            out[k] = max(out.get(k, -math.inf), v)
    return out
