"""The descriptor-binning routine shared by the fused (K3) and split (K7)
kernels (``csrc/sift_common.cuh``) and K3's warp-wide histogram and peak
search (``csrc/orient_desc.cu``), restated in numpy at the kernels' widths
and orders and held against the plain versions (``ops/descriptor.py``,
``ops/orient.py``) and the JAX package's weights, so that the algorithm is
checked here, where the kernels cannot run."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cudasift_tpu.ops.descriptor import _spatial_bin_matrix

from cudasift_tpu_torch.ops import descriptor, orient
from cudasift_tpu_torch.ops.texture import fast_atan2

CSRC = Path(descriptor.__file__).resolve().parents[1] / "csrc"
F32 = np.float32


def axis_weight(d: int) -> np.float32:
    """``sift::axis_weight``: the trilinear weight of window offset d."""
    return F32(2 * d + 1) / F32(8) if d < 4 else F32(15 - 2 * d) / F32(8)


def window(cell: int):
    """Grid indices 4*cell-2 .. 4*cell+5 clipped to the grid, with their
    window offsets."""
    return [(d, 4 * cell - 2 + d) for d in range(8) if 0 <= 4 * cell - 2 + d <= 15]


def test_window_form_equals_the_weight_table():
    """Every non-zero of the (16, 256) spatial weight table lies in its
    cell's 8x8 window with the window's compile-time weight, and the window
    holds nothing else."""
    table = descriptor.spatial_weights(torch.device("cpu")).numpy()
    windowed = np.zeros_like(table)
    for rc in range(16):
        r, c = divmod(rc, 4)
        for di, i in window(r):
            for dj, j in window(c):
                windowed[rc, 16 * i + j] = axis_weight(di) * axis_weight(dj)
    np.testing.assert_array_equal(windowed, table)
    assert (windowed != 0).sum(axis=1).max() == 64 and (windowed != 0).sum(axis=1).min() == 36
    # The JAX package's per-axis weights are the same eight numbers.
    axis = _spatial_bin_matrix()
    for cell in range(4):
        got = np.zeros(16, F32)
        for d, i in window(cell):
            got[i] = axis_weight(d)
        np.testing.assert_array_equal(got, axis[:, cell])


def stage_samples(dx: np.ndarray, dy: np.ndarray):
    """``sift::stage_sample`` for (N, 256) gradients: (g1, g2, angle bin)."""
    tdx, tdy = torch.as_tensor(dx), torch.as_tensor(dy)
    g = torch.arange(256)
    gx = (g % 16).to(torch.float32) - 7.5
    gy = (g // 16).to(torch.float32) - 7.5
    gweight = torch.exp(-(gx * gx + gy * gy) / 128.0)
    grad = (torch.sqrt(tdx * tdx + tdy * tdy) * gweight).numpy()
    angf = (4.0 / 3.1415 * fast_atan2(tdy, tdx) + 4.0).numpy()
    raw = np.floor(angf)
    frac = angf - raw
    return grad * (F32(1) - frac), grad * frac, raw.astype(np.int64) & 7


def half_window(g1, g2, ai, r, c, a, half):
    """``sift::half_window``: rows ascending, the half's four columns
    ascending within a row, one multiply and one add a sample; a column
    outside the grid adds the plane's zero border, which changes nothing."""
    am = (a + 7) & 7
    acc = np.zeros(g1.shape[0], F32)
    for di, i in window(r):
        for dj in range(4 * half, 4 * half + 4):
            j = 4 * c - 2 + dj
            if not 0 <= j <= 15:
                continue
            ws = axis_weight(di) * axis_weight(dj)
            k = 16 * i + j
            ga = np.where(ai[:, k] == a, g1[:, k], np.where(ai[:, k] == am, g2[:, k], F32(0)))
            acc = acc + ws * ga
    return acc


def inv_norm(v: np.ndarray, pair: bool):
    """``sift::inv_norm`` on (N, 128) entries: the shuffle tree over the
    entry index's low four bits, then the eight group sums in ascending
    order. With ``pair`` the block's 256 lanes hold every entry twice: lane
    ``16 * cell + 8 * half + a`` of warp w holds entry ``16 * w + 8 * cell + a``,
    and the tree's last step crosses lane bit 4; else lane = entry."""
    x = v * v
    if pair:
        t = np.arange(256)
        x = x[:, ((t >> 5) << 4) | (((t >> 4) & 1) << 3) | (t & 7)]
    lanes = np.arange(x.shape[1])
    for m in (1, 2, 4, 16 if pair else 8):
        x = x + x[:, lanes ^ m]
    group = x.reshape(x.shape[0], 8, -1)             # a warp, or half a warp
    assert (group == group[:, :, :1]).all()          # every lane of a group agrees
    total = group[:, 0, 0]
    for i in range(1, 8):
        total = total + group[:, i, 0]
    return F32(1) / np.sqrt(np.maximum(total, F32(1e-30)))


def kernel_binning(dx: np.ndarray, dy: np.ndarray, pair: bool) -> np.ndarray:
    """``sift::bin_and_write`` in numpy: (N, 128) descriptors."""
    g1, g2, ai = stage_samples(dx, dy)
    v = np.zeros((dx.shape[0], 128), F32)
    for e in range(128):
        rc, a = divmod(e, 8)
        r, c = divmod(rc, 4)
        left = half_window(g1, g2, ai, r, c, a, 0)
        right = half_window(g1, g2, ai, r, c, a, 1)
        v[:, e] = left + right
    n1 = inv_norm(v, pair)
    t1 = np.minimum(v * n1[:, None], F32(0.2))
    n2 = inv_norm(t1, pair)
    return t1 * n2[:, None]


def gradients(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    dx = rng.standard_normal((n, 256)).astype(F32)
    dy = rng.standard_normal((n, 256)).astype(F32)
    dx[0] *= 0                       # vertical gradients only: angles on a bin edge
    dy[1] *= 0
    dx[2, ::3] = 0
    dy[2, ::3] = 0                   # samples without a gradient
    dx[3] = np.abs(dx[3]) * 50       # one dominant direction: the 0.2 clamp bites
    dy[3] *= 0.01
    dx[4:6] *= 1e-4                  # small magnitudes
    dy[4:6] *= 1e-4
    return dx, dy


@pytest.mark.parametrize("seed", [71, 72, 73])
def test_kernel_binning_order_matches_plain(seed):
    dx, dy = gradients(seed)
    ref = descriptor.bin_descriptors(torch.as_tensor(dx), torch.as_tensor(dy)).numpy()
    pair = kernel_binning(dx, dy, pair=True)
    side = kernel_binning(dx, dy, pair=False)
    # The two layouts (two lanes an entry; one thread an entry) share the
    # window order and the norm tree: equal bit for bit.
    np.testing.assert_array_equal(pair, side)
    # Against the plain binning only the order of sums differs.
    np.testing.assert_allclose(pair, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(pair, axis=1), 1.0, atol=1e-6)
    assert float(pair[3].max()) > 0.2 and np.isfinite(pair).all()


def test_kernel_binning_of_a_flat_patch_is_finite():
    z = np.zeros((2, 256), F32)
    out = kernel_binning(z, z, pair=True)
    ref = descriptor.bin_descriptors(torch.as_tensor(z), torch.as_tensor(z)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert not out.any()


def test_gauss_table_in_the_header_is_the_plain_window():
    src = (CSRC / "sift_common.cuh").read_text()
    body = re.search(r"GRID_GAUSS\[64\] = \{(.*?)\};", src, re.S).group(1)
    table = np.array([float(x) for x in re.findall(r"([0-9.]+)f", body)], F32).reshape(8, 8)
    g = torch.arange(256)
    gx = (g % 16).to(torch.float32) - 7.5
    gy = (g // 16).to(torch.float32) - 7.5
    ref = torch.exp(-(gx * gx + gy * gy) / 128.0).numpy().reshape(16, 16)
    fold = np.array([7 - i if i < 8 else i - 8 for i in range(16)])   # sift::grid_gauss
    np.testing.assert_allclose(table[fold[:, None], fold[None, :]], ref, rtol=1.2e-7, atol=0)


def test_sources_share_the_one_routine():
    header = (CSRC / "sift_common.cuh").read_text()
    assert "wsp" not in header and "fill_spatial_weights" not in header
    k3 = (CSRC / "orient_desc.cu").read_text()
    k7 = (CSRC / "descriptor.cu").read_text()
    for src in (k3, k7):
        assert "sift::bin_and_write<" in src and "sift::stage_sample(" in src
    code = re.sub(r"//.*", "", k3)
    assert "sm[32]" not in code and "peaks[32]" not in code     # no local-memory arrays
    assert "warp_argmax(" in code and "__shfl_sync(" in code   # the peak search is warp-wide


# ---- K3's histogram and peak search -----------------------------------------

def warp_histogram(bins: np.ndarray, wgt: np.ndarray) -> np.ndarray:
    """(121,) bins and weights -> (32,) histogram in the kernel's order: warps
    0-3 each add their own 32 samples in lane order, then the four partial
    histograms are added in warp order."""
    b = np.full(128, -1)
    w = np.zeros(128, F32)
    b[:121], w[:121] = bins, wgt
    part = np.zeros((4, 32), F32)
    for warp in range(4):
        for i in range(32):
            k = 32 * warp + i
            if b[k] >= 0:
                part[warp, b[k]] = part[warp, b[k]] + w[k]
    return ((part[0] + part[1]) + part[2]) + part[3]


def warp_argmax(v: np.ndarray):
    """The butterfly of ``warp_argmax``: (value, index) after five xor steps,
    the lower index winning a tie; every lane must agree."""
    v = v.copy()
    i = np.arange(32)
    lanes = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        ov, oi = v[lanes ^ m], i[lanes ^ m]
        take = (ov > v) | ((ov == v) & (oi < i))
        v, i = np.where(take, ov, v), np.where(take, oi, i)
    assert (v == v[0]).all() and (i == i[0]).all()
    return v[0], int(i[0])


def warp_peaks(hist: np.ndarray):
    """K3's peak search on one (32,) histogram, lane = bin."""
    hist = hist.astype(F32)
    lane = np.arange(32)

    def at(x, off):
        return x[(lane + off) & 31]

    sm = F32(6) * hist + F32(4) * (at(hist, 31) + at(hist, 1)) + at(hist, 30) + at(hist, 2)
    peak = np.where((sm > at(sm, 31)) & (sm >= at(sm, 1)), sm, F32(0))
    max1, i1 = warp_argmax(peak)
    max2, i2 = warp_argmax(np.where(lane == i1, F32(-np.inf), peak))

    def degrees(i, m):
        v1, v2 = sm[(i + 1) & 31], sm[(i + 31) & 31]
        denom = F32(2) * m - v1 - v2
        p = F32(i) + F32(0.5) * (v1 - v2) / (F32(1e-30) if denom == 0 else denom)
        return F32(11.25) * (p + F32(32) if p < 0 else p)

    return degrees(i1, max1), degrees(i2, max2), bool(max2 > F32(0.8) * max1), i1, i2


def planted_histograms():
    rng = np.random.default_rng(74)
    rows = [rng.random(32).astype(F32) for _ in range(6)]
    flat = np.zeros(32, F32)
    rows.append(flat.copy())                                 # no peak at all: bins 0 and 1
    for a, b in ((3, 17), (17, 3), (0, 31), (31, 0), (0, 16), (30, 1)):
        h = flat.copy()
        h[a] = h[b] = 5.0                                    # two equal peaks: lowest bin first
        rows.append(h)
    h = flat.copy()
    h[[4, 12, 20, 28]] = 2.0                                 # four equal peaks
    rows.append(h)
    h = flat.copy()
    h[0], h[31], h[15] = 9.0, 8.5, 3.0                       # a peak across the wrap-around
    rows.append(h)
    h = flat.copy()
    h[31], h[0], h[1] = 4.0, 4.0, 1.0                        # a plateau over bins 31 and 0
    rows.append(h)
    h = np.ones(32, F32)                                     # constant: no bin is strictly above
    rows.append(h)
    h = flat.copy()
    h[7] = 1.0                                               # one peak only: second stays at bin 0
    rows.append(h)
    h = flat.copy()
    h[0] = 1.0                                               # the only peak at bin 0: second from 1
    rows.append(h)
    return np.stack(rows)


def test_warp_peak_search_matches_plain_on_planted_ties():
    hists = planted_histograms()
    p1, p2, has2 = (t.numpy() for t in orient.histogram_peaks(torch.as_tensor(hists)))
    firsts = []
    for n, h in enumerate(hists):
        o1, o2, second, i1, i2 = warp_peaks(h)
        np.testing.assert_allclose(o1, p1[n], rtol=1e-6, atol=1e-6, err_msg=str(n))
        np.testing.assert_allclose(o2, p2[n], rtol=1e-6, atol=1e-6, err_msg=str(n))
        assert second == bool(has2[n]), n
        assert i1 != i2
        firsts.append((i1, i2))
    assert firsts[6] == (0, 1)                               # nothing set
    assert firsts[7][0] == 3 and firsts[8][0] == 3           # ties go to the lowest bin
    assert firsts[-2] == (7, 0) and firsts[-1] == (0, 1)     # where the second search starts


def test_warp_histogram_order_matches_plain_sum():
    rng = np.random.default_rng(75)
    for _ in range(4):
        bins = rng.integers(0, 32, 121)
        bins[:40] = 5                                        # one crowded bin over two warps
        wgt = rng.random(121).astype(F32) * 10
        got = warp_histogram(bins, wgt)
        ref = np.zeros(32, np.float64)
        np.add.at(ref, bins, wgt.astype(np.float64))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
