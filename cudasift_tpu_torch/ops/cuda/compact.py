"""K8 wrapper: raster-order compaction of the extrema mask.

Replaces the TPU kernel ``cudasift_tpu/ops/pallas/compact.py``
(``compact_mask_pallas``), which ``SiftParams.use_pallas_compact`` selects
for the candidate compaction of each octave. The CUDA kernel
(``csrc/compact.cu``) is bound by device memory. It reads the mask as
16-byte words in two launches: per-segment counts, then a write launch in
which each block sums the counts before it and ranks its set entries by
in-word, warp and block prefixes. No count is read back to the host, no
atomic decides an order and no state outlives a call, so the result is that
of its plain version, ``detect.compact_mask``, bit for bit, and the call can
be captured in a CUDA graph. A mask view that does not start on a 16-byte
boundary is taken as it is: the kernel reads its partial first and last
words byte by byte. CPU tensors take the plain version.
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

# The kernel's shape (csrc/compact.cu): THREADS threads a block, each with
# STEPS loads of VECTOR mask entries, so SEGMENT entries a block.
THREADS = 256
VECTOR = 16
STEPS = 4
SEGMENT = THREADS * STEPS * VECTOR


def segments(n: int, misalign: int) -> int:
    """Blocks of each launch for ``n`` entries starting ``misalign`` bytes
    past a 16-byte boundary (at least one)."""
    return max(-(-(n + misalign) // SEGMENT), 1)


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
    # One allocation, as a single call is dispatch-bound: the indices, count
    # and total, then the per-segment counts the two launches pass on.
    nseg = segments(n, mask.data_ptr() % VECTOR)
    buf = torch.empty((capacity + 2 + nseg,), dtype=torch.int32, device=mask.device)
    at = buf.data_ptr()
    KERNEL(mask.device, ptr(mask), n, int(capacity), ctypes.c_void_p(at + 4 * (capacity + 2)),
           ctypes.c_void_p(at), ctypes.c_void_p(at + 4 * capacity),
           ctypes.c_void_p(at + 4 * (capacity + 1)))
    return buf[:capacity], buf[capacity], buf[capacity + 1]
