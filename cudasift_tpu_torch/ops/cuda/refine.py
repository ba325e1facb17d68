"""K2 wrapper: count-gated subpixel refinement of compacted candidates.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/refine.py``
(``refine_candidates_pallas``). The CUDA kernel (``csrc/refine.cu``) is
bound by the latency of 27 scattered reads per candidate; one thread per
slot reads its cube straight from the DoG stack, so none of the TPU's
layout tiers exist here. Slots at or past the on-device ``count`` are
skipped without a host read of the count. Its plain version is
``detect.refine_candidates``, which CPU tensors take.
"""

from __future__ import annotations

import ctypes

import torch

from .. import detect
from ...utils.build import Kernel, check, ptr

KERNEL = Kernel(
    "refine.cu", "refine_candidates",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
     ctypes.c_void_p, ctypes.c_void_p],
    flags=("-fmad=false",),
    replaces="cudasift_tpu/ops/pallas/refine.py:358",
)


def refine_candidates(dog: torch.Tensor, flat_idx: torch.Tensor,
                      count: torch.Tensor, edge_limit: float,
                      lowest_scale: float) -> detect.Candidates:
    """Refined candidates for the first ``count`` slots of ``flat_idx``.

    ``dog`` (7, H, W) f32, ``flat_idx`` (K,) int32 into the (5, H, W) mask
    grid, ``count`` () int32. Same results as ``detect.refine_candidates``.
    """
    if dog.device.type == "cpu":
        return detect.refine_candidates(dog, flat_idx, count, edge_limit,
                                        lowest_scale)
    if dog.ndim != 3 or dog.shape[0] != 7:
        raise ValueError(f"expected a (7, H, W) DoG stack, got {tuple(dog.shape)}")
    _, h, w = dog.shape
    k = flat_idx.shape[0]
    check(dog, "dog", torch.float32, (7, h, w), dog.device)
    check(flat_idx, "flat_idx", torch.int32, (k,), dog.device)
    check(count, "count", torch.int32, (), dog.device)
    out = torch.empty((5, k), dtype=torch.float32, device=dog.device)
    valid = torch.empty((k,), dtype=torch.bool, device=dog.device)
    KERNEL(dog.device, ptr(dog), ptr(flat_idx), ptr(count), k, h, w, float(edge_limit),
           float(lowest_scale), ptr(out), ptr(valid))
    return detect.Candidates(xpos=out[0], ypos=out[1], scale=out[2],
                             sharpness=out[3], edgeness=out[4], valid=valid)
