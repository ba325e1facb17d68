"""The least work of the ScaleUp kernel (``csrc/scale_up.cu``: a frame
upsampled 2x), whatever implements it.

Bytes: the (H, W) float32 frame read once (4 B a pixel) and the (2H, 2W)
float32 output written once (16 B an input pixel). Its 8 adds and
multiplies an input pixel are not counted: at under half an operation a
byte the bytes bound it. The bound is device memory's: where the output fits
in the card's 50 MB L2 (19.7 MB at 1280x960) the kernel can end under it,
its write-back landing in the kernels after it.
"""

from siftbench.counts import peaks

BYTES_PER_PX = 4 + 16


def work(height: int, width: int) -> tuple[float, float]:
    """(operations, bytes) of one frame's upsample."""
    return 0.0, float(BYTES_PER_PX * height * width)


def bound_s(height: int, width: int) -> tuple[float, str]:
    ops, nbytes = work(height, width)
    return peaks.bound_s(ops, nbytes, "f32")
