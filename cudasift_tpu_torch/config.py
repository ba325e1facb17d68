"""Static configuration of the PyTorch port.

Numpy-only tables and frozen parameter dataclasses, field for field the
same as ``cudasift_tpu.config`` so a parameter object converts between the
two packages by field name (``convert.params_from_jax``). Octave shapes,
candidate capacities and Gaussian tap tables are plain Python/numpy values,
resolved before any tensor is touched.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np

# Number of DoG scales searched for extrema per octave (cudaSiftD.h:8).
NUM_SCALES = 5
# Number of Gaussian scales per octave = NUM_SCALES + 3 (cudaSiftD.h:35).
NUM_LAPLACE_SCALES = NUM_SCALES + 3
# Gaussian blur kernel radius (cudaSiftD.h:38).
LAPLACE_R = 4
# Edge-response limit: reject if trace^2 >= limit * det (cudaSiftH.cu:213).
EDGE_LIMIT = 10.0


def gaussian_kernel_1d(radius: int, variance: float) -> np.ndarray:
    """Normalized symmetric 1-D Gaussian taps, length ``2*radius+1``:
    ``k[j] = exp(-j^2 / (2*variance))`` normalized to sum 1."""
    j = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(j * j) / (2.0 * variance))
    return (k / k.sum()).astype(np.float32)


def laplace_kernels(num_octaves: int, init_blur: float = 0.0) -> np.ndarray:
    """Per-octave, per-scale 1-D Gaussian taps for the scale-space pyramid.

    Octave ``o`` (0 = full resolution) uses the residual base blur carried
    through the ScaleDown chain, ``b_{o+1} = sqrt(b_o^2 + 0.5^2) / 2``, and
    scale ``s`` targets sigma ``2^((s-1)/NUM_SCALES)``. Returns
    ``(num_octaves, 8, 9)`` float32 symmetric taps.
    """
    out = np.zeros((num_octaves, NUM_LAPLACE_SCALES, 2 * LAPLACE_R + 1), np.float64)
    blur = float(init_blur)
    for o in range(num_octaves):
        scale = 2.0 ** (-1.0 / NUM_SCALES)
        diff_scale = 2.0 ** (1.0 / NUM_SCALES)
        for s in range(NUM_LAPLACE_SCALES):
            var = scale * scale - blur * blur
            j = np.arange(0, LAPLACE_R + 1, dtype=np.float64)
            half = np.exp(-(j * j) / (2.0 * var))
            norm = half[0] + 2.0 * half[1:].sum()
            half /= norm
            out[o, s, LAPLACE_R:] = half
            out[o, s, :LAPLACE_R] = half[1:][::-1]
            scale *= diff_scale
        blur = math.sqrt(blur * blur + 0.25) / 2.0
    return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SiftParams:
    """Knobs of the extraction pipeline (same fields as the JAX package).

    Fields that select TPU-only machinery are accepted so parameter objects
    convert one-to-one, but they do not change what the port computes:

    - ``refine_layout`` has no effect: the CUDA refine kernel reads the DoG
      stack directly, there are no layout tiers to choose from;
    - ``compute_dtype`` is float32 throughout.

    ``use_fused=False`` selects the split orientation/descriptor path (the
    count-gated histogram and descriptor kernels, descriptors always
    ``"exact"``), and only that selects it: the JAX package also falls back
    to it when an octave base is too large for the fused TPU kernel's VMEM
    budget (frames about 8K wide), a limit the port's fused kernel does not
    have. ``use_pallas_compact=True`` compacts each octave's candidates with
    the compaction kernel instead of plain PyTorch; both give the same
    indices.

    Settings whose kernels are not ported yet raise ``NotImplementedError``
    in ``extract_sift``: ``grad_mode="fast"`` / ``fast_gradients=True``, and
    ``use_pallas=False`` on a CUDA tensor (the port has no non-kernel GPU
    path).
    """

    num_octaves: int = 5
    init_blur: float = 1.0
    thresh: float = 3.0
    lowest_scale: float = 0.0
    scale_up: bool = False
    max_pts: int = 32768
    # Fraction of octave DoG voxels reserved as extrema-candidate slots
    # before compaction; the schedule in ``candidate_capacity`` scales it
    # per octave.
    candidate_fraction: float = 1.0 / 2048.0
    min_candidates: int = 256
    edge_limit: float = EDGE_LIMIT
    compute_dtype: str = "float32"
    # Run the hand-written kernels on CUDA tensors (CPU tensors always take
    # the kernels' plain PyTorch versions).
    use_pallas: bool = True
    use_fused: bool = True
    fast_gradients: bool = False
    # Descriptor gradient sampler of the fused orientation+descriptor
    # kernel: "exact" (4 bilinear taps per sample, the reference
    # arithmetic) or "shift" (rotation-aligned gradient fields from
    # fractional +-(cos a, sin a) shifts, sampled bilinearly).
    grad_mode: str = "shift"
    refine_layout: str = "auto"
    use_pallas_compact: bool = False

    def octave_shapes(self, height: int, width: int) -> tuple[tuple[int, int], ...]:
        """Image shape per octave, index 0 = full working resolution."""
        h = height * (2 if self.scale_up else 1)
        w = width * (2 if self.scale_up else 1)
        shapes = []
        for _ in range(self.num_octaves):
            shapes.append((h, w))
            h //= 2
            w //= 2
        return tuple(shapes)

    @property
    def lowest_scale_effective(self) -> float:
        """lowestScale is doubled under scale_up (cudaSiftH.cu:127)."""
        return self.lowest_scale * (2.0 if self.scale_up else 1.0)

    def candidate_capacity(self, height: int, width: int, octave: int = 0) -> int:
        """Fixed extrema-candidate slots for an octave of the given shape.

        Extrema density per pixel rises about 3x per octave, so the
        per-voxel fraction grows by a (1, 4, 8, 16, 32) schedule (and 3x per
        octave beyond), bounded by a per-voxel ceiling, then clamped to
        ``[min_candidates, max_pts]`` and rounded up to 128.
        """
        voxels = height * width * NUM_SCALES
        mult = (1, 4, 8, 16, 32)[min(octave, 4)] * 3 ** max(0, octave - 4)
        cap = int(voxels * self.candidate_fraction * mult)
        cap = min(cap, voxels // (48 if octave < 5 else 12))
        cap = max(self.min_candidates, cap)
        cap = min(cap, self.max_pts)
        return (cap + 127) // 128 * 128

    @cached_property
    def laplace_kernels(self) -> np.ndarray:
        """(num_octaves, 8, 9) Gaussian tap table; octave 0 = full res."""
        return laplace_kernels(self.num_octaves, 0.0)


@dataclasses.dataclass(frozen=True)
class MatchParams:
    """Knobs of the brute-force matcher (matching.cu:1090-1206)."""

    tile_n2: int = 2048  # column tile of the plain matcher
    use_bf16: bool = False  # bfloat16-rounded inputs, float32 accumulation


@dataclasses.dataclass(frozen=True)
class HomographyParams:
    """Knobs of RANSAC + refinement (matching.cu:1000, geomFuncs.cpp:6).

    The defaults mirror the JAX package; they differ from the reference
    demo's call (num_loops=10000, min_score=0.0, max_ambiguity=0.80), which
    callers pass explicitly.
    """

    num_loops: int = 1024
    min_score: float = 0.85
    max_ambiguity: float = 0.95
    thresh: float = 5.0
