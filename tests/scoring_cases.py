"""Inputs for RANSAC's hypothesis scoring (``ops.cuda.ransac``), in numpy,
shared by the CPU tests against the JAX package and the card tests against
the plain version."""

import numpy as np

from cudasift_tpu_torch.utils.synth import known_homography

H_IMG, W_IMG = 192, 256
CAP = 512

# (num_h, num_pts, plant): one hypothesis, the 10000 of the benchmark's
# RANSAC, a count that fills no 512-hypothesis tile; no, eight, a ragged
# number (300 fills no 256-point split) and every point live; a row of zeros
# and a point whose deno is 0.
CASES = [(1, 300, None), (10000, 300, None), (1300, 300, None),
         (64, 0, None), (64, 8, None), (64, CAP, None),
         (64, 300, "zero_row"), (64, 300, "deno_zero")]
IDS = ["one_hypothesis", "ten_thousand", "ragged_hypothesis_tile", "no_points",
       "eight_points", "every_point", "zero_row", "deno_zero"]


def scoring_case(num_h, num_pts, plant=None, seed=35):
    """(h8 (num_h, 8), [x1, y1, x2, y2] (CAP,)) float32: hypotheses around
    a known homography (a third far off) and matched points under it with
    1.5 px noise and 30% outliers, ``num_pts`` live and the dead slots zero,
    as in a ``SiftData``. ``plant`` puts in a row of zeros (what the
    isfinite mask leaves of a failed solve) or a point whose ``deno`` is 0
    for one row."""
    rng = np.random.default_rng(seed)
    hm = known_homography(H_IMG, W_IMG)
    h8 = (hm / hm[2, 2]).reshape(9)[:8] * (1 + rng.normal(0, 0.02, (num_h, 8)))
    h8[::3] += rng.normal(0, 0.5, (len(h8[::3]), 8)) * [1, 1, 20, 1, 1, 20, 1e-3, 1e-3]
    x1 = rng.uniform(0, W_IMG, CAP)
    y1 = rng.uniform(0, H_IMG, CAP)
    p = hm @ np.stack([x1, y1, np.ones(CAP)])
    x2 = p[0] / p[2] + rng.normal(0, 1.5, CAP)
    y2 = p[1] / p[2] + rng.normal(0, 1.5, CAP)
    out = rng.uniform(size=CAP) < 0.3
    x2[out] = rng.uniform(0, W_IMG, out.sum())
    y2[out] = rng.uniform(0, H_IMG, out.sum())
    row = num_h // 2
    if plant == "zero_row":
        h8[row] = 0.0
    elif plant == "deno_zero":
        h8[row, 6:] = (-0.5, 1e-3)             # deno = -0.5 * 2 + 1e-3 * 0 + 1 = 0
        x1[1], y1[1] = 2.0, 0.0
    fields = [np.where(np.arange(CAP) < num_pts, f, 0.0).astype(np.float32)
              for f in (x1, y1, x2, y2)]
    return h8.astype(np.float32), fields
