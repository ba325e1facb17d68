"""K8 wrapper: raster-order compaction of the extrema mask.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/compact.py``
(``compact_mask_pallas``), which ``SiftParams.use_pallas_compact`` selects
for the candidate compaction of each octave. The CUDA kernel
(``csrc/compact.cu``) is bound by device memory: it reads the (5, H, W)
bool mask twice (per-segment counts, then ballot ranks) with one scan of
the segment counts between, and writes the indices at their global ranks.
No count is read back to the host and no atomic decides an order, so the
result is that of its plain version, ``detect.compact_mask``, bit for bit;
CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import detect
from ...utils.build import Kernel, check, ptr

KERNEL = Kernel(
    "compact.cu", "compact_mask",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    replaces="cudasift_tpu/ops/pallas/compact.py:204",
)

SEGMENT = 4096   # mask entries per block of the kernel


def compact_mask(mask: torch.Tensor, capacity: int):
    """(flat_idx (capacity,) int32, count () int32, total () int32) of the
    set entries of a bool ``mask`` of any shape, flattened in raster order:
    the first ``count = min(total, capacity)`` indices, zeros past them."""
    if mask.device.type == "cpu":
        return detect.compact_mask(mask, capacity, with_total=True)
    n = mask.numel()
    if n >= 2 ** 31:
        raise ValueError(f"mask has {n} entries; int32 indices need fewer than 2**31")
    check(mask, "mask", torch.bool, tuple(mask.shape), mask.device)
    dev = mask.device
    seg = torch.empty((max(-(-n // SEGMENT), 1),), dtype=torch.int32, device=dev)
    idx = torch.empty((capacity,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    KERNEL(ptr(mask), n, int(capacity), ptr(seg), ptr(idx), ptr(count), ptr(total))
    return idx, count, total
