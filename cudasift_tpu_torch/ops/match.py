"""Brute-force descriptor matching (FindMaxCorr10 / MatchSiftData,
matching.cu:301-397, 1090-1206).

``match_descriptors`` is the plain PyTorch version of the matcher kernel
(``ops/cuda/match.py``): a loop over column tiles of the second set with a
per-row running (best, second, index), so the score matrix is never held
whole. Tiles are disjoint, so merging two triples needs no index
deduplication.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MatchParams
from ..sift_data import SiftData


def match_descriptors(d1: torch.Tensor, d2: torch.Tensor, n1, n2,
                      tile: int = 2048, use_bf16: bool = False):
    """Best/second-best cosine scores of ``d1`` rows against ``d2`` rows.

    d1 (N1, 128), d2 (N2, 128), with only the first ``n1``/``n2`` rows
    valid. Returns (score, ambiguity, index), each of length N1, with best
    and second clamped at 0, ``ambiguity = second / (best + 1e-6)`` and the
    lowest index winning ties; rows at or past ``n1`` are zero.
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
