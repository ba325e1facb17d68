"""The plain reference of descriptor matching (MatchSiftData,
matching.cu:1090-1206), in plain PyTorch: every valid descriptor of the first
set against every valid one of the second, best and second-best cosine score
per row (clamped at 0, the lowest column winning ties), ambiguity
``second / (best + 1e-6)``, and the matched point's position."""

from __future__ import annotations

import dataclasses

import torch

from .precision import FLOAT32, Precision


def top2(d1: torch.Tensor, d2: torch.Tensor, n1: int, n2: int, prec: Precision,
         rows_per_block: int = 4096):
    """(best, second, index) of the first ``n1`` rows of ``d1`` against the
    first ``n2`` rows of ``d2``, over blocks of rows; rows past ``n1`` are 0."""
    n1_cap = d1.shape[0]
    dev = d1.device
    best = torch.zeros((n1_cap,), dtype=torch.float32, device=dev)
    second = torch.zeros_like(best)
    index = torch.zeros((n1_cap,), dtype=torch.int32, device=dev)
    if n1 == 0 or n2 == 0:
        return best, second, index
    b = prec.operand(d2[:n2])
    with prec.products():
        for r0 in range(0, n1, rows_per_block):
            r1 = min(n1, r0 + rows_per_block)
            scores = prec.operand(d1[r0:r1]) @ b.T
            if n2 >= 2:
                top = torch.topk(scores, 2, dim=1)
                # topk breaks equal scores by no stated rule: take the
                # lowest column that reaches the best.
                first = (scores == top.values[:, :1]).to(torch.int8).argmax(dim=1)
                masked = scores.scatter(1, first[:, None], -torch.inf)
                sec = masked.max(dim=1).values
                bst = top.values[:, 0]
            else:
                first = torch.zeros((r1 - r0,), dtype=torch.int64, device=dev)
                bst = scores[:, 0]
                sec = torch.full_like(bst, -torch.inf)
            best[r0:r1] = torch.clamp(bst, min=0.0)
            second[r0:r1] = torch.clamp(sec, min=0.0)
            index[r0:r1] = first.to(torch.int32)
    return best, second, index


def match(data1, data2, prec: Precision = FLOAT32):
    """A copy of ``data1`` with score, ambiguity, match and the matched
    point's coordinates filled in."""
    n1, n2 = int(data1.num_pts), int(data2.num_pts)
    best, second, index = top2(data1.data, data2.data, n1, n2, prec)
    ambiguity = second / (best + 1e-6)
    valid = torch.arange(data1.xpos.shape[0], device=best.device) < n1
    z = torch.zeros((), dtype=torch.float32, device=best.device)
    idx = index.to(torch.int64)
    return dataclasses.replace(
        data1,
        score=torch.where(valid, best, z),
        ambiguity=torch.where(valid, ambiguity, z),
        match=torch.where(valid, index, -1).to(torch.int32),
        match_xpos=torch.where(valid, data2.xpos[idx], z),
        match_ypos=torch.where(valid, data2.ypos[idx], z))
