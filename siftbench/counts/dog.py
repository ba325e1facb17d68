"""The least work of K1 (``csrc/dog.cu``: 8 Gaussian scales, 7 DoG planes
and the extremum mask of every octave), whatever implements it.

Each octave base is blurred into 8 scales by 9-tap separable passes; with the
taps' symmetry a pass is 5 multiplies and 8 adds, so 8 x 2 x 13 = 208
float32 operations a pixel. Bytes: the base read once (4 B a pixel) and the
5-plane extremum mask written once (5 B a pixel); the DoG planes are
intermediate and not counted.
"""

from siftbench.counts import peaks

FLOP_PER_PX = 8 * 2 * 13
BYTES_PER_PX = 4 + 5


def octave_pixels(height: int, width: int, num_octaves: int) -> int:
    total, h, w = 0, height, width
    for _ in range(num_octaves):
        total += h * w
        h //= 2
        w //= 2
    return total


def work(height: int, width: int, num_octaves: int) -> tuple[float, float]:
    """(operations, bytes) of one frame's octaves."""
    px = octave_pixels(height, width, num_octaves)
    return float(FLOP_PER_PX * px), float(BYTES_PER_PX * px)


def bound_s(height: int, width: int, num_octaves: int) -> tuple[float, str]:
    ops, nbytes = work(height, width, num_octaves)
    return peaks.bound_s(ops, nbytes, "f32")
