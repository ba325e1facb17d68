"""K4 and K5 wrappers: the brute-force matcher with a fused running top-2,
and the candidate sweep of its hybrid exact tier, both on the tensor cores.

K4 replaces the TPU kernel ``cudasift_tpu/ops/pallas/match.py``
(``match_descriptors_pallas``, default tier). The CUDA kernel
(``csrc/match.cu``) computes every score in 3xTF32 on ``mma.sync`` (one
bfloat16 product for ``use_bf16``), keeps a running top-2 per row and
column range, and merges the ranges in a second small kernel; the score
matrix is never written out, and no library GEMM is called. The wrapper
allocates the per-range partials with ``torch.empty``. One call of the
wrapper counts as one launch of ``KERNEL`` (the partial and the merge
kernel together). Its plain version is ``ops.match.match_descriptors``,
which CPU tensors take. ``match_top2`` is the same launch with the merge
kernel also writing each row's second-best score, the triple the sharded
matcher (``parallel.sharding``) merges across shards; its plain version is
``ops.match.match_top2``.

K5 replaces the TPU kernel ``_sweep_candidates`` of the same file, reached
by ``match_descriptors(..., rescore_k=k)``. The CUDA kernel
(``csrc/match_sweep.cu``) scores every pair in the three-product bfloat16
split on ``mma.sync`` and keeps each row's top two per 256-column chunk;
the float32 rescore of the top ``k`` candidates is plain PyTorch
(``ops.match.exact_rescore``), as it is XLA in the JAX package. Its plain
version is ``ops.match.sweep_candidates``, which CPU tensors take.

Both kernels read the live counts on the device, so no host sync is needed
when they are passed as 0-d int32 CUDA tensors; both sets must be
contiguous (N, 128) float32 on 16-byte boundaries (the kernels copy rows
with 16-byte ``cp.async``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import match as plain
from ...utils.build import Kernel, check, count_tensor, ptr

KERNEL = Kernel(
    "match.cu", "match_descriptors",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    replaces="cudasift_tpu/ops/pallas/match.py:255",
)
# Columns of the second set per block of K4 (``SPLIT`` in csrc/match.cu).
MATCH_SPLIT = 1024

SWEEP_KERNEL = Kernel(
    "match_sweep.cu", "sweep_candidates",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    replaces="cudasift_tpu/ops/pallas/match.py:160",
)


def _check_sets(d1: torch.Tensor, d2: torch.Tensor, n1, n2):
    """Check both descriptor sets; return (n1, n2) as 0-d int32 tensors on
    their device."""
    dev = d1.device
    check(d1, "d1", torch.float32, (d1.shape[0], 128), dev)
    check(d2, "d2", torch.float32, (d2.shape[0], 128), dev)
    for name, d in (("d1", d1), ("d2", d2)):
        if d.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    return count_tensor(n1, "n1", dev), count_tensor(n2, "n2", dev)


def sweep_candidates(d1: torch.Tensor, d2: torch.Tensor, n1, n2):
    """(cand_s, cand_i), each (N1, 2 * ceil(N2 / 256)): every row's top two
    (score, column) per 256-column chunk of the bfloat16x3 scores; see
    ``ops.match.sweep_candidates``."""
    if d1.device.type == "cpu":
        return plain.sweep_candidates(d1, d2, n1, n2)
    n1_t, n2_t = _check_sets(d1, d2, n1, n2)
    n1_cap, n2_cap = d1.shape[0], d2.shape[0]
    nch = -(-n2_cap // plain.SWEEP_CHUNK)
    cand_s = torch.empty((n1_cap, 2 * nch), dtype=torch.float32, device=d1.device)
    cand_i = torch.empty((n1_cap, 2 * nch), dtype=torch.int32, device=d1.device)
    SWEEP_KERNEL(d1.device, ptr(d1), ptr(d2), n1_cap, n2_cap, ptr(n1_t), ptr(n2_t), nch,
                 ptr(cand_s), ptr(cand_i))
    return cand_s, cand_i


def _launch_k4(d1: torch.Tensor, d2: torch.Tensor, n1, n2, use_bf16: bool,
               with_second: bool):
    """One launch of K4: (score, ambiguity, index, second), ``second`` None
    unless ``with_second`` (the kernel then gets a null pointer for it)."""
    n1_t, n2_t = _check_sets(d1, d2, n1, n2)
    dev = d1.device
    n1_cap, n2_cap = d1.shape[0], d2.shape[0]
    splits = -(-n2_cap // MATCH_SPLIT)
    # Scratch: each row's (best, second) and index per column range.
    part_s = torch.empty((n1_cap, splits, 2), dtype=torch.float32, device=dev)
    part_i = torch.empty((n1_cap, splits), dtype=torch.int32, device=dev)
    score = torch.empty((n1_cap,), dtype=torch.float32, device=dev)
    ambiguity = torch.empty((n1_cap,), dtype=torch.float32, device=dev)
    index = torch.empty((n1_cap,), dtype=torch.int32, device=dev)
    second = torch.empty((n1_cap,), dtype=torch.float32, device=dev) if with_second else None
    KERNEL(dev, ptr(d1), ptr(d2), n1_cap, n2_cap, ptr(n1_t), ptr(n2_t),
           1 if use_bf16 else 0, splits, ptr(part_s), ptr(part_i),
           ptr(score), ptr(ambiguity), ptr(index),
           None if second is None else ptr(second))
    return score, ambiguity, index, second


def match_descriptors(d1: torch.Tensor, d2: torch.Tensor, n1, n2,
                      use_bf16: bool = False, tile: int = 2048,
                      rescore_k: int | None = None):
    """(score, ambiguity, index) for the first ``n1`` rows of ``d1`` against
    the first ``n2`` rows of ``d2``; see ``ops.match.match_descriptors``.
    ``n1``/``n2`` are ints or 0-d int32 tensors; ``tile`` only shapes the
    plain version's loop. ``rescore_k`` (without ``use_bf16``) selects the
    hybrid exact tier, ``ops.match.match_descriptors_hybrid``, with the
    sweep kernel on CUDA tensors."""
    if rescore_k is not None and not use_bf16:
        return plain.match_descriptors_hybrid(d1, d2, n1, n2, rescore_k,
                                              sweep=sweep_candidates)
    if d1.device.type == "cpu":
        return plain.match_descriptors(d1, d2, n1, n2, tile=tile, use_bf16=use_bf16)
    return _launch_k4(d1, d2, n1, n2, use_bf16, with_second=False)[:3]


def match_top2(d1: torch.Tensor, d2: torch.Tensor, n1, n2,
               use_bf16: bool = False, tile: int = 2048):
    """(best, second, index): K4's triple before the division, each of
    length N1; see ``ops.match.match_top2``. Arguments as
    ``match_descriptors``'s."""
    if d1.device.type == "cpu":
        return plain.match_top2(d1, d2, n1, n2, tile=tile, use_bf16=use_bf16)
    score, _, index, second = _launch_k4(d1, d2, n1, n2, use_bf16, with_second=True)
    return score, second, index
