"""Brute-force descriptor matching (FindMaxCorr10 / MatchSiftData,
matching.cu:301-397, 1090-1206).

``match_descriptors`` is the plain PyTorch version of the matcher kernel
(``ops/cuda/match.py``): a loop over column tiles of the second set with a
per-row running (best, second, index), so the score matrix is never held
whole. Tiles are disjoint, so merging two triples needs no index
deduplication.

``match_descriptors_hybrid`` is the hybrid exact tier (``rescore_k``): a
bfloat16x3 candidate sweep keeping each row's top two per 256-column chunk
(``sweep_candidates`` is the plain version of the sweep kernel), then
``exact_rescore`` of each row's top-k candidates in float32.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MatchParams
from ..sift_data import SiftData


def match_top2(d1: torch.Tensor, d2: torch.Tensor, n1, n2,
               tile: int = 2048, use_bf16: bool = False):
    """Best and second-best cosine scores of ``d1`` rows against ``d2`` rows.

    d1 (N1, 128), d2 (N2, 128), with only the first ``n1``/``n2`` rows
    valid. Returns (best, second, index), each of length N1, with best and
    second clamped at 0 and the lowest index winning ties; rows at or past
    ``n1`` are zero. The plain version of ``ops/cuda/match.py:match_top2``.
    """
    n1_cap = d1.shape[0]
    n2_cap = d2.shape[0]
    if use_bf16:
        d1 = d1.to(torch.bfloat16).to(torch.float32)
        d2 = d2.to(torch.bfloat16).to(torch.float32)
    dev = d1.device
    best = torch.full((n1_cap,), -torch.inf, dtype=torch.float32, device=dev)
    second = torch.full_like(best, -torch.inf)
    index = torch.full((n1_cap,), -1, dtype=torch.int64, device=dev)
    for t0 in range(0, n2_cap, tile):
        scores = d1 @ d2[t0:t0 + tile].T
        col = t0 + torch.arange(scores.shape[1], device=dev)
        scores = torch.where(col < n2, scores, -torch.inf)
        t_best = scores.max(dim=1).values
        t_arg = torch.argmax(scores, dim=1)
        masked = scores.scatter(1, t_arg[:, None], -torch.inf)
        t_second = masked.max(dim=1).values
        new_second = torch.maximum(torch.minimum(best, t_best),
                                   torch.maximum(second, t_second))
        index = torch.where(t_best > best, t0 + t_arg, index)
        best = torch.maximum(best, t_best)
        second = new_second
    best = torch.clamp(best, min=0.0)
    second = torch.clamp(second, min=0.0)
    index = torch.clamp(index, min=0).to(torch.int32)
    rows = torch.arange(n1_cap, device=dev) < n1
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return (torch.where(rows, best, zero), torch.where(rows, second, zero),
            torch.where(rows, index, 0))


def match_descriptors(d1: torch.Tensor, d2: torch.Tensor, n1, n2,
                      tile: int = 2048, use_bf16: bool = False):
    """(score, ambiguity, index), each of length N1: ``match_top2``'s best
    and index, and ``ambiguity = second / (best + 1e-6)``; rows at or past
    ``n1`` are zero."""
    best, second, index = match_top2(d1, d2, n1, n2, tile=tile, use_bf16=use_bf16)
    return best, second / (best + 1e-6), index


# Hybrid tier: columns per chunk of the sweep, the score of a masked column
# and the index that never wins (the TPU kernel's constants).
SWEEP_CHUNK = 256
DEAD = -1e30
BIG = 2 ** 30


def split_bf16(a: torch.Tensor):
    """(hi, lo) float32 tensors holding bfloat16 values, ``hi = bf16(a)``
    and ``lo = bf16(a - hi)``, both rounded to nearest even."""
    hi = a.to(torch.bfloat16).to(torch.float32)
    lo = (a - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def split_tf32(a: torch.Tensor):
    """(big, small) float32 tensors holding TF32 values, ``big = tf32(a)``
    and ``small = tf32(a - big)``, each rounded as the card's
    ``cvt.rna.tf32.f32``: to nearest with ties away from zero, keeping 10
    mantissa bits. The split of the matcher kernel's 3xTF32 products; the
    tests use it to restate that arithmetic on the CPU."""
    def rna(x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(a)
    return big, rna(a - big)


def sweep_candidates(d1: torch.Tensor, d2: torch.Tensor, n1, n2):
    """Candidate sweep of the hybrid matcher (plain version of
    ``ops/cuda/match.py:sweep_candidates``).

    Scores are the three-product bfloat16 split ``hi.hi + (hi.lo + lo.hi)``
    in float32; columns at or past ``n2`` score ``DEAD``. For each row and
    each 256-column chunk (the second set padded to whole chunks) returns the
    top two (score, column), higher score first, lower column on equal
    scores, as entries 2c and 2c+1 of (cand_s (N1, 2*chunks) f32, cand_i
    (N1, 2*chunks) int32). Rows at or past ``n1`` hold ``DEAD`` and 0.
    """
    n1_cap, n2_cap = d1.shape[0], d2.shape[0]
    dev = d1.device
    nch = -(-n2_cap // SWEEP_CHUNK)
    pad = nch * SWEEP_CHUNK - n2_cap
    if pad:
        d2 = torch.cat([d2, torch.zeros((pad, d2.shape[1]), dtype=d2.dtype, device=dev)])
    a_hi, a_lo = split_bf16(d1)
    b_hi, b_lo = split_bf16(d2)
    scores = a_hi @ b_hi.T + (a_hi @ b_lo.T + a_lo @ b_hi.T)
    col = torch.arange(nch * SWEEP_CHUNK, device=dev)
    s = torch.where(col < n2, scores, DEAD).reshape(n1_cap, nch, SWEEP_CHUNK)
    cc = col.reshape(nch, SWEEP_CHUNK)
    b1 = s.max(dim=2).values
    i1 = torch.where(s == b1[..., None], cc, BIG).min(dim=2).values
    s2 = torch.where(cc == i1[..., None], -torch.inf, s)
    b2 = s2.max(dim=2).values
    i2 = torch.where(s2 == b2[..., None], cc, BIG).min(dim=2).values
    cand_s = torch.stack([b1, b2], dim=2).reshape(n1_cap, 2 * nch)
    cand_i = torch.stack([i1, i2], dim=2).reshape(n1_cap, 2 * nch).to(torch.int32)
    rows = (torch.arange(n1_cap, device=dev) < n1)[:, None]
    return torch.where(rows, cand_s, DEAD), torch.where(rows, cand_i, 0)


def exact_rescore(cand_s: torch.Tensor, cand_i: torch.Tensor, d1: torch.Tensor,
                  d2: torch.Tensor, n2, k: int):
    """Rescore each row's top-``k`` sweep candidates in float32 (the JAX
    package's ``_exact_rescore``): returns (best, second, index), the lowest
    column winning equal exact scores and -1 where no candidate lives.
    Candidates tied at the k-th place are taken in candidate order."""
    k = min(k, cand_s.shape[1])
    order = torch.sort(cand_s, dim=1, descending=True, stable=True).indices[:, :k]
    top_s = torch.gather(cand_s, 1, order)
    ci = torch.gather(cand_i, 1, order).to(torch.int64)
    live = (ci < BIG) & (top_s > DEAD)
    g = d2[torch.clamp(ci, 0, d2.shape[0] - 1)]                 # (N1, k, 128)
    exact = torch.bmm(g, d1[:, :, None])[:, :, 0]
    exact = torch.where(live & (ci < n2), exact, DEAD)
    best = exact.max(dim=1).values
    bi = torch.where(exact == best[:, None], ci, BIG).min(dim=1).values
    second = torch.where(ci == bi[:, None], DEAD, exact).max(dim=1).values
    return best, second, torch.where(bi == BIG, -1, bi)


def match_descriptors_hybrid(d1: torch.Tensor, d2: torch.Tensor, n1, n2,
                             rescore_k: int = 8, sweep=sweep_candidates):
    """The hybrid exact tier of ``match_descriptors``: same outputs, with
    every score decided by the float32 rescore of the ``sweep``'s top
    ``rescore_k`` candidates per row. ``sweep`` is the plain sweep or the
    kernel's wrapper."""
    cand_s, cand_i = sweep(d1, d2, n1, n2)
    best, second, index = exact_rescore(cand_s, cand_i, d1, d2, n2, rescore_k)
    best = torch.clamp(best, min=0.0)
    second = torch.clamp(second, min=0.0)
    index = torch.clamp(index, min=0).to(torch.int32)
    rows = torch.arange(d1.shape[0], device=d1.device) < n1
    zero = torch.zeros((), dtype=torch.float32, device=d1.device)
    return (torch.where(rows, best, zero),
            torch.where(rows, second / (best + 1e-6), zero),
            torch.where(rows, index, 0))


def match_sift_data(data1: SiftData, data2: SiftData, tile: int | None = None,
                    use_bf16: bool | None = None, use_pallas: bool = True,
                    params: MatchParams | None = None) -> SiftData:
    """MatchSiftData (matching.cu:1090-1206): a copy of ``data1`` with
    score, ambiguity, match and the matched point's coordinates filled in.

    On CUDA tensors the matcher kernel runs (``use_pallas=False`` raises
    there); CPU tensors take its plain version. ``params`` supplies the
    defaults for ``tile``/``use_bf16``; explicit keyword arguments win.
    Unlike RANSAC and IRLS it is not a captured program: one kernel and
    five elementwise operations leave a graph no dispatch to save, and a
    replay would first copy both descriptor sets in.
    """
    from .cuda.match import match_descriptors as match_kernel

    p = params if params is not None else MatchParams()
    tile = p.tile_n2 if tile is None else tile
    use_bf16 = p.use_bf16 if use_bf16 is None else use_bf16
    if data1.device.type == "cuda" and not use_pallas:
        raise NotImplementedError(
            "use_pallas=False on CUDA: the port has no non-kernel GPU matcher")
    best, ambiguity, index = match_kernel(
        data1.data, data2.data, data1.num_pts, data2.num_pts,
        use_bf16=use_bf16, tile=tile)
    valid = data1.valid_mask()
    z = torch.zeros((), dtype=torch.float32, device=data1.device)
    idx = index.to(torch.int64)
    return dataclasses.replace(
        data1,
        score=torch.where(valid, best, z),
        ambiguity=torch.where(valid, ambiguity, z),
        match=torch.where(valid, index, -1).to(torch.int32),
        match_xpos=torch.where(valid, data2.xpos[idx], z),
        match_ypos=torch.where(valid, data2.ypos[idx], z),
    )
