"""K4 wrapper: brute-force matcher with a fused running top-2.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/match.py``
(``match_descriptors_pallas``, default tier). The CUDA kernel
(``csrc/match.cu``) is bound by arithmetic: N1*N2*128 float32
multiply-adds, computed by the kernel itself on the CUDA cores (no cuBLAS,
no TF32), with the score matrix never written out. The second set's live
count is read on the device, so no host sync is needed. Its plain version
is ``ops.match.match_descriptors``, which CPU tensors take.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.build import Kernel, check, ptr

KERNEL = Kernel(
    "match.cu", "match_descriptors",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p],
    replaces="cudasift_tpu/ops/pallas/match.py:255",
)


def match_descriptors(d1: torch.Tensor, d2: torch.Tensor, n1, n2,
                      use_bf16: bool = False, tile: int = 2048):
    """(score, ambiguity, index) for the first ``n1`` rows of ``d1`` against
    the first ``n2`` rows of ``d2``; see ``ops.match.match_descriptors``.
    ``n1``/``n2`` are ints or 0-d int32 tensors; ``tile`` only shapes the
    plain version's loop."""
    if d1.device.type == "cpu":
        from ..match import match_descriptors as plain

        return plain(d1, d2, n1, n2, tile=tile, use_bf16=use_bf16)
    dev = d1.device
    n1_cap, n2_cap = d1.shape[0], d2.shape[0]
    check(d1, "d1", torch.float32, (n1_cap, 128), dev)
    check(d2, "d2", torch.float32, (n2_cap, 128), dev)
    counts = []
    for name, n in (("n1", n1), ("n2", n2)):
        if not isinstance(n, torch.Tensor):
            n = torch.tensor(int(n), dtype=torch.int32, device=dev)
        check(n, name, torch.int32, (), dev)
        counts.append(n)
    score = torch.empty((n1_cap,), dtype=torch.float32, device=dev)
    ambiguity = torch.empty((n1_cap,), dtype=torch.float32, device=dev)
    index = torch.empty((n1_cap,), dtype=torch.int32, device=dev)
    KERNEL(ptr(d1), ptr(d2), n1_cap, n2_cap, ptr(counts[0]), ptr(counts[1]),
           1 if use_bf16 else 0,
           ptr(score), ptr(ambiguity), ptr(index))
    return score, ambiguity, index
