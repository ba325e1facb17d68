"""The orientation kernel with its peak search inside (K6,
``csrc/orient.cu``) and the refine kernel's index arithmetic (K2,
``csrc/refine.cu``), restated in numpy at the kernels' widths and orders and
held against the plain versions and the JAX package, here where the kernels
cannot run; the launch-floor launcher on the CPU."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudasift_tpu.ops.orient import histogram_peaks as jax_histogram_peaks
from cudasift_tpu.ops.pallas.orient import orientation_histograms_pallas

from cudasift_tpu_torch.ops import orient as torient
from cudasift_tpu_torch.ops import texture
from cudasift_tpu_torch.ops.cuda import orient, probes, refine
from cudasift_tpu_torch.utils.synth import make_test_image

from test_torch_descriptor_binning import planted_histograms, warp_peaks

CSRC = Path(orient.__file__).resolve().parents[2] / "csrc"
F32 = np.float32
SIDE, MARGIN = 16, 7


def staged_grid(img, x, y):
    """K6's footprint and grid for one keypoint: the 16 x 16 corner of the
    patch staged by 32 lanes in 8 steps (lane -> column lane % 16 of rows
    lane / 16, + 2, ...), then the 13 x 13 bilinear grid read from it with
    the index clamped to [0, 14]. Returns (grid (169,), rbase, cbase)."""
    h, w = img.shape
    flx, fly = np.floor(x), np.floor(y)
    ox, oy = max(int(flx) - MARGIN, 0), max(int(fly) - MARGIN, 0)
    fx, fy = F32(x - flx), F32(y - fly)
    cbase, rbase = int(flx) - ox - 6, int(fly) - oy - 6
    patch = np.full((SIDE, SIDE), np.nan, F32)
    for lane in range(32):
        prow, pcol = lane >> 4, lane & 15
        col = min(ox + pcol, w - 1)
        for j in range(SIDE // 2):
            patch[2 * j + prow, pcol] = img[min(oy + 2 * j + prow, h - 1), col]
    assert not np.isnan(patch).any()
    one = F32(1)
    g = np.empty(169, F32)
    for i in range(169):
        uy, ux = divmod(i, 13)
        r = min(max(rbase + uy, 0), SIDE - 2)
        c = min(max(cbase + ux, 0), SIDE - 2)
        g[i] = (one - fy) * ((one - fx) * patch[r, c] + fx * patch[r, c + 1]) \
            + fy * ((one - fx) * patch[r + 1, c] + fx * patch[r + 1, c + 1])
    return g, rbase, cbase


def lane_histogram(bins: np.ndarray, wgt: np.ndarray) -> np.ndarray:
    """(121,) bins and weights -> (32,) histogram in K6's order: lane l adds
    its samples l, l + 32, ... into column l of a zeroed (32 bins, 32 lanes)
    table in sample order, then bin b adds its row over the lanes in lane
    order."""
    table = np.zeros((32, 32), F32)
    for k in range(121):
        table[bins[k], k % 32] = table[bins[k], k % 32] + wgt[k]
    hist = np.zeros(32, F32)
    for lane in range(32):
        hist = hist + table[:, lane]
    return hist


def kernel_histogram(img, x, y, sc):
    """K6 for one keypoint in numpy: staged grid, the 121 samples' bins and
    weights (the Gaussian from a table over the squared distance), the
    histogram through a column a lane."""
    g, _, _ = staged_grid(img, x, y)
    g = g.reshape(13, 13)
    dx = (g[1:12, 2:13] - g[1:12, 0:11]).reshape(-1)
    dy = (g[2:13, 1:12] - g[0:11, 1:12]).reshape(-1)
    theta = texture.atan2_poly(torch.as_tensor(dy), torch.as_tensor(dx)).numpy()
    bins = np.floor(F32(16) * theta / F32(3.1416) + F32(16.5)).astype(np.int64)
    bins = np.where(bins > 31, 0, bins)
    i2s2 = F32(-1) / (F32(4.5) * sc * sc)
    gauss = np.exp(i2s2 * np.arange(51, dtype=F32)).astype(F32)
    uy, ux = np.divmod(np.arange(121), 11)
    d2 = (ux - 5) ** 2 + (uy - 5) ** 2
    wgt = np.sqrt(dx * dx + dy * dy) * gauss[d2]
    return lane_histogram(bins, wgt)


def border_keypoints(h, w):
    """Keypoints within 7 px of every border and corner, past the image box
    on every side, and in the interior."""
    edge_x = [-3.4, -0.6, 0.0, 0.4, 3.3, 5.99, 6.0, 6.9, 7.0, 7.6, w - 7.2, w - 3.5, w - 1.0,
              w - 0.3, w + 2.6, w + 40.0]
    edge_y = [-2.2, -0.6, 0.0, 0.4, 3.3, 5.99, 6.0, 6.9, 7.0, 7.6, h - 7.2, h - 3.5, h - 1.0,
              h - 0.3, h + 4.1, h + 25.0]
    pts = [(x, y) for x in edge_x for y in (2.5, h / 2 + 0.25, h - 2.5)]
    pts += [(x, y) for y in edge_y for x in (2.5, w / 2 + 0.75, w - 2.5)]
    pts += [(x, y) for x in (-1.5, 0.0, w - 1.0, w + 0.5) for y in (-1.5, 0.0, h - 1.0, h + 0.5)]
    pts += [(w / 3, h / 3), (w / 2 + 0.5, h / 2 + 0.5), (2 * w / 3 + 0.1, 2 * h / 3 + 0.9)]
    x = np.asarray([p[0] for p in pts], F32)
    y = np.asarray([p[1] for p in pts], F32)
    s = np.random.default_rng(81).uniform(0.9, 2.6, len(pts)).astype(F32)
    return x, y, s


@pytest.mark.parametrize("h,w", [(96, 160), (17, 9), (40, 13)])
def test_staged_footprint_matches_plain_histograms(h, w):
    img = make_test_image(h, w, seed=82)
    x, y, s = border_keypoints(h, w)
    ref = torient.keypoint_histograms(*(torch.as_tensor(a) for a in (img, x, y, s)),
                                      texture.SPLIT_ORIENT).numpy()
    assert ref.shape == (len(x), 32)
    for k in range(len(x)):
        _, rbase, cbase = staged_grid(img, x[k], y[k])
        # The origin follows the keypoint: only the clamp at 0 ever binds, so
        # the staged corner's [0, 14] equals the patch's [0, 15] x [0, 127].
        assert rbase <= 1 and cbase <= 1
        got = kernel_histogram(img, x[k], y[k], s[k])
        np.testing.assert_allclose(got, ref[k], rtol=1e-5, atol=1e-5 * max(ref[k].max(), 1.0),
                                   err_msg=f"keypoint {k} at ({x[k]}, {y[k]})")
    assert (ref.sum(axis=1) > 0).mean() > 0.9


def angle_err(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 360.0 - d)


def test_orientation_peaks_plain_matches_pallas_then_peaks():
    """The one-launch entry on CPU tensors (its plain version) against the
    JAX package's Pallas kernel in interpret mode followed by its
    ``histogram_peaks``; bars as the histogram test's (tests/test_torch_split.py:
    bfloat16 selection flips single samples between adjacent bins)."""
    h, w = 96, 160
    rng = np.random.default_rng(83)
    img = make_test_image(h, w, seed=83)
    x = np.concatenate([rng.uniform(9, w - 10, 18), [0.4, 3.7, 5.7, 60.2, 110.6, -0.3]]).astype(F32)
    y = np.concatenate([rng.uniform(9, h - 10, 18), [40.1, 2.2, 50.8, 1.6, 4.6, 30.7]]).astype(F32)
    s = rng.uniform(0.95, 1.87, 24).astype(F32)
    launches = orient.KERNEL.launches
    hist, p1, p2, h2 = orient.orientation_peaks(*(torch.as_tensor(a) for a in (img, x, y, s)), 20)
    assert orient.KERNEL.launches == launches                  # CPU tensors: plain version
    ref_hist = orientation_histograms_pallas(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                                             jnp.asarray(s), interpret=True)
    r1, r2, rh2 = (np.asarray(a) for a in jax_histogram_peaks(ref_hist))
    ref_hist = np.asarray(ref_hist)
    for i in range(20):
        assert np.corrcoef(hist[i].numpy(), ref_hist[i])[0, 1] > 0.995, i
    d1 = angle_err(p1.numpy()[:20], r1[:20])
    assert np.median(d1) < 0.2 and (d1 < 2.0).mean() >= 0.9, d1
    same = d1 < 2.0
    agree2 = (h2.numpy()[:20] == rh2[:20])[same]
    assert agree2.mean() >= 0.8, agree2
    both = same & h2.numpy()[:20] & rh2[:20]
    if both.any():
        assert np.median(angle_err(p2.numpy()[:20], r2[:20])[both]) < 2.0
    # The count gate: zeros and no second peak at and past the count.
    for t in (hist, p1, p2, h2):
        assert not t[20:].any()
    # The peaks are histogram_peaks of the histograms, on the live slots.
    q1, q2, g2 = torient.histogram_peaks(hist)
    assert torch.equal(p1[:20], q1[:20]) and torch.equal(p2[:20], q2[:20])
    assert torch.equal(h2[:20], g2[:20])
    only = orient.orientation_histograms(*(torch.as_tensor(a) for a in (img, x, y, s)), 20)
    assert torch.equal(only, hist)
    empty = orient.orientation_peaks(*(torch.as_tensor(a) for a in (img, x, y, s)), 0)
    assert not any(bool(t.any()) for t in empty)


def test_peak_search_on_planted_ties_through_the_entry():
    """The kernel's warp-wide search (restated in numpy) and the plain
    search agree on planted ties, plateaus and empty histograms, and the
    entry's gate zeroes what the plain search reports for an empty slot
    (bins 0 and 1: 0 and 11.25 degrees)."""
    hists = planted_histograms()
    p1, p2, has2 = (t.numpy() for t in torient.histogram_peaks(torch.as_tensor(hists)))
    for n, hrow in enumerate(hists):
        o1, o2, second, i1, i2 = warp_peaks(hrow)
        np.testing.assert_allclose([o1, o2], [p1[n], p2[n]], rtol=1e-6, atol=1e-6, err_msg=str(n))
        assert second == bool(has2[n]) and i1 != i2
    assert p1[6] == 0.0 and p2[6] == 11.25 and not has2[6]     # the empty histogram
    img = torch.zeros((20, 20))
    pos = torch.full((3,), 10.0)
    out = orient.orientation_peaks(img, pos, pos, torch.ones(3), 3)
    assert float(out[2][0]) == 11.25 and not out[3].any()      # live but flat: as plain
    out = orient.orientation_peaks(img, pos, pos, torch.ones(3), 1)
    assert not out[1][1:].any() and not out[2][1:].any()       # dead: zeros


def test_lane_histogram_order_matches_plain_sum():
    rng = np.random.default_rng(84)
    for _ in range(4):
        bins = rng.integers(0, 32, 121)
        bins[:70] = 9                                        # one crowded bin over every lane
        wgt = rng.random(121).astype(F32) * 10
        ref = np.zeros(32, np.float64)
        np.add.at(ref, bins, wgt.astype(np.float64))
        np.testing.assert_allclose(lane_histogram(bins, wgt), ref, rtol=1e-6, atol=0)


def test_sources_share_the_histogram_and_the_peak_search():
    header = re.sub(r"//.*", "", (CSRC / "sift_common.cuh").read_text())
    for name in ("warp_argmax(", "peak_degrees(", "find_peaks(", "orientation_bin("):
        assert header.count(f" {name}") >= 1, name
    for source in ("orient.cu", "orient_desc.cu"):
        code = re.sub(r"//.*", "", (CSRC / source).read_text())
        assert "sift::find_peaks(" in code and "sift::orientation_bin(" in code, source
        assert "warp_argmax(float" not in code and "atomicAdd" not in code
    k6 = re.sub(r"//.*", "", (CSRC / "orient.cu").read_text())
    # Shared are the bin formula and the peak search, not the binning: K3's
    # four warps hand their samples round by shuffles (its own loop), K6's
    # one warp bins through a column a lane (the order lane_histogram restates).
    assert "warp_histogram" not in header
    assert "if (bi == lane) acc = acc + wi;" in re.sub(r"//.*", "", (CSRC / "orient_desc.cu").read_text())
    assert "bi == lane" not in k6 and "ROW = 33;" in k6
    # Both C entry points, the older one by its name; geometry constants as here.
    assert 'extern "C" int orientation_histograms(' in k6
    assert 'extern "C" int orientation_peaks(' in k6
    assert f"SIDE = {SIDE};" in k6 and f"MARGIN = {MARGIN};" in k6 and "MAX_DIST2 = 50;" in k6
    assert orient.KERNEL.symbol == "orientation_peaks" and "-fmad=false" in orient.KERNEL.flags


def test_refine_index_arithmetic_fits_32_bits():
    """The kernel's 32-bit decomposition of a flat index and its cube offsets
    against the 64-bit one at 1920 x 1080, over every plane boundary, the
    frame's corners and a strided sweep."""
    h, w = 1080, 1920
    hw = h * w
    assert 7 * hw <= refine.INDEX_MAX
    fi = np.unique(np.concatenate([
        np.arange(0, 5 * hw, 9973), np.arange(5 * hw - 4000, 5 * hw),
        *[np.arange(max(p * hw - 3, 0), min(p * hw + 3, 5 * hw)) for p in range(6)],
        *[np.arange(p * hw + r * w - 2, p * hw + r * w + 2) for p in range(5)
          for r in (1, 2, h - 2, h - 1)]]))
    fi = fi[(fi >= 0) & (fi < 5 * hw)]

    def decompose(idx, dtype):
        idx = idx.astype(dtype)
        hw_t, w_t = dtype(hw), dtype(w)
        s = idx // hw_t
        rem = idx - s * hw_t
        y = rem // w_t
        x = rem - y * w_t
        y = np.minimum(np.maximum(y, dtype(1)), dtype(h - 2))
        x = np.minimum(np.maximum(x, dtype(1)), dtype(w - 2))
        centre = (s + dtype(1)) * hw_t + y * w_t + x
        offsets = [centre + dtype(ds) * hw_t + dtype(dy) * w_t + dtype(dx)
                   for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        return s, y, x, np.stack(offsets)

    with np.errstate(over="raise"):
        got = decompose(fi, np.int32)
    ref = decompose(fi, np.int64)
    for a, b in zip(got, ref):
        assert a.dtype == np.int32 and np.array_equal(a.astype(np.int64), b)
    assert ref[3].min() >= 0 and ref[3].max() < 7 * hw
    # Past 2^31 entries the wrapper refuses (no silent 64-bit path); CPU
    # tensors take the plain version, which indexes in 64 bits.
    big = torch.empty((7, 20000, 16000), device="meta")
    idx = torch.empty((8,), dtype=torch.int32, device="meta")
    cnt = torch.empty((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        refine.refine_candidates(big, idx, cnt, 10.0, 0.0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        refine.refine_candidates(torch.empty((7, 200, 160), device="meta"), idx, cnt, 10.0, 0.0)
    code = re.sub(r"//.*", "", (CSRC / "refine.cu").read_text())
    assert "long long" not in code and "THREADS = 32;" in code


def test_launch_floor_on_the_cpu_is_a_no_op():
    before = probes.LAUNCH_FLOOR.launches
    assert probes.launch_floor("cpu") is None and probes.launch_floor("cpu", 160, 32) is None
    assert probes.LAUNCH_FLOOR.launches == before
    assert probes.LAUNCH_FLOOR not in probes.KERNELS and probes.LAUNCH_FLOOR.source == "probes.cu"
    for bad in ((0, 32), (1, 0), (1, 2048)):
        with pytest.raises(ValueError):
            probes.launch_floor("cpu", *bad)
    with pytest.raises(ValueError):
        probes.launch_floor("meta")
    assert 'extern "C" int probe_launch_floor(' in (CSRC / "probes.cu").read_text()
