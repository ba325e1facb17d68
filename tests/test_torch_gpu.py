"""The CUDA kernels (K1-K8 with K3's three samplers, the patch-acquisition
kernels P1 and the probes P2, RANSAC's scoring kernel, the weighted refit,
ScaleUp) against their plain versions on the card, the pipeline, fused and
split, on the card against
the CPU, the entry points' captured programs (extraction, RANSAC, IRLS)
against their eager runs, ``utils.trace`` on a replayed program and on the
profiler's clock, the sharded matcher and extraction and the dry run of
``cudasift_tpu_torch.parallel`` on a mesh that repeats the card, and the
demo CLI on the card. Marked ``gpu``: they skip without a CUDA device. On the card run
them with ``python -m pytest tests/test_torch_gpu.py -q --noconftest``: the
conftest only configures jax, which these tests do not use."""

import json

import numpy as np
import pytest
import torch

import cudasift_tpu_torch as ct
import scoring_cases
from cudasift_tpu_torch import cli
from cudasift_tpu_torch.config import laplace_kernels
from cudasift_tpu_torch.ops import convolve, detect
from cudasift_tpu_torch.ops import match as match_plain
from cudasift_tpu_torch.ops import orient as orient_plain
from cudasift_tpu_torch.ops.cuda import (FUSED_PATH, acquire, compact, descriptor, dog, lstsq,
                                         match, orient, orient_desc, probes, ransac, refine,
                                         scale_up)
from cudasift_tpu_torch import pipeline
from cudasift_tpu_torch.ops.cuda import LIBRARY
from cudasift_tpu_torch.utils import io, jit, synth, trace
from cudasift_tpu_torch.utils.synth import make_test_image

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def octave(cuda, h=200, w=300):
    return convolve.low_pass(torch.as_tensor(make_test_image(h, w, seed=51), device=cuda), 1.0)


# The octave shapes of a 1920x1080 frame, then ragged ones: widths that are
# not multiples of 4 (scalar stores) or of the 64-column tile, heights not
# multiples of the 32-row tile, and frames smaller than a tile's halo.
@pytest.mark.parametrize("h,w,o", [
    (1080, 1920, 0), (540, 960, 1), (270, 480, 2), (135, 240, 3), (67, 120, 4),
    (7, 9, 0), (67, 121, 1), (135, 241, 2), (5, 3, 0), (2, 40, 0), (200, 300, 0),
])
def test_dog_kernel_matches_plain(cuda, h, w, o):
    img = octave(cuda, h, w)
    taps = laplace_kernels(5)[o]
    thresh = 3.0 if min(h, w) > 100 else 1.0
    before = dog.KERNEL.launches
    got = dog.dog_and_mask(img, taps, thresh, 10.0)
    ref = dog.dog_and_mask_plain(img, taps, thresh, 10.0)
    torch.cuda.synchronize()
    assert dog.KERNEL.launches == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if min(h, w) > 100:
        assert int(ref[1].sum()) > 0


def test_refine_kernel_matches_plain(cuda):
    img = octave(cuda)
    d, m = dog.dog_and_mask(img, laplace_kernels(1)[0], 2.0, 10.0)
    idx, cnt = detect.compact_mask(m, 512)
    got = refine.refine_candidates(d, idx, cnt, 10.0, 0.0)
    ref = detect.refine_candidates(d, idx, cnt, 10.0, 0.0)
    assert int(cnt) > 10 and torch.equal(got.valid, ref.valid)
    for name in ("xpos", "ypos", "scale", "sharpness", "edgeness"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=3e-7, atol=0)


def assert_candidates_equal(got, ref, what):
    for name in ("xpos", "ypos", "scale", "sharpness", "edgeness", "valid"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), (what, name)


# Octave shapes of a 1920x1080 frame, ragged and tiny ones, and capacities off
# the block size; the count at 0, inside and at the capacity.
@pytest.mark.parametrize("h,w,o,cap", [
    (1080, 1920, 0, 5120), (540, 960, 1, 5120), (270, 480, 2, 2560), (135, 240, 3, 1280),
    (67, 120, 4, 640), (67, 121, 1, 77), (135, 241, 2, 1), (9, 7, 0, 33), (3, 3, 0, 31),
])
def test_refine_kernel_equals_plain_at_octave_and_ragged_shapes(cuda, h, w, o, cap):
    img = octave(cuda, h, w)
    d, m = dog.dog_and_mask(img, laplace_kernels(5)[o], 1.0, 10.0)
    idx, cnt = detect.compact_mask(m, cap)
    # Every slot a real index, so that count = capacity reads no filler.
    g = torch.Generator(device=cuda).manual_seed(66)
    idx = torch.where(torch.arange(cap, device=cuda) < cnt, idx,
                      torch.randint(0, 5 * h * w, (cap,), device=cuda, generator=g,
                                    dtype=torch.int32))
    for count in sorted({0, int(cnt), cap // 2, cap}):
        c = torch.tensor(count, dtype=torch.int32, device=cuda)
        before = refine.KERNEL.launches
        got = refine.refine_candidates(d, idx, c, 10.0, 0.3)
        assert refine.KERNEL.launches == before + 1
        ref = detect.refine_candidates(d, idx, c, 10.0, 0.3)
        assert_candidates_equal(got, ref, (h, w, count))
        assert not got.valid[count:].any() and not got.xpos[count:].any()
    if min(h, w) > 100:
        assert int(got.valid.sum()) > 0
    with pytest.raises(ValueError, match="32-bit"):
        refine.refine_candidates(torch.empty((7, 20000, 16000), device="meta"), idx, c, 10.0, 0.0)


@pytest.mark.parametrize("mode", ["shift", "exact", "fast"])
def test_orient_desc_kernel_matches_plain(cuda, mode):
    img = octave(cuda)
    rng = np.random.default_rng(52)
    n = 64
    x = torch.tensor(rng.uniform(-1, 300, n), dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.uniform(-1, 200, n), dtype=torch.float32, device=cuda)
    s = torch.tensor(rng.uniform(0.9, 2.4, n), dtype=torch.float32, device=cuda)
    live = torch.arange(n, device=cuda) % 7 != 0
    got = orient_desc.orient_and_describe(img, x, y, s, live, mode)
    ref = orient_desc.orient_and_describe_plain(img, x, y, s, live, mode)
    dori = (got[2] - ref[2]).abs()
    assert float(dori.median()) < 0.2 and float((dori < 2.0).float().mean()) >= 0.9
    same = live & (dori < 1e-3)
    assert int(same.sum()) >= 0.9 * int(live.sum())
    assert float((got[0] - ref[0]).abs()[same].max()) < 2e-2
    assert not got[0][~live].any() and not got[4][~live].any()
    again = orient_desc.orient_and_describe(img, x, y, s, live, mode)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def border_keypoints(cuda, h=200, w=300):
    """Keypoints within 7 px of each border and corner (and past the box),
    each at a scale on either side of the 1.72 patch-size switch, and a few
    in the interior; every sixth slot dead."""
    edge_x = [-0.6, 0.0, 0.4, 3.3, 6.9, w - 7.2, w - 3.5, w - 1.0, w - 0.3]
    edge_y = [-0.6, 0.0, 0.4, 3.3, 6.9, h - 7.2, h - 3.5, h - 1.0, h - 0.3]
    pts = [(x, y) for x in edge_x for y in (2.5, h / 2 + 0.25, h - 2.5)]
    pts += [(x, y) for y in edge_y for x in (2.5, w / 2 + 0.75, w - 2.5)]
    pts += [(x, y) for x in (0.0, w - 1.0) for y in (0.0, h - 1.0)]
    pts += [(w / 3, h / 3), (w / 2 + 0.5, h / 2 + 0.5), (2 * w / 3 + 0.1, 2 * h / 3 + 0.9)]
    xs, ys, ss = [], [], []
    for x, y in pts:
        for sc in (0.9, 1.72, 1.7200001, 2.6):
            xs.append(x)
            ys.append(y)
            ss.append(sc)
    n = len(xs)
    x = torch.tensor(xs, dtype=torch.float32, device=cuda)
    y = torch.tensor(ys, dtype=torch.float32, device=cuda)
    s = torch.tensor(ss, dtype=torch.float32, device=cuda)
    live = torch.arange(n, device=cuda) % 6 != 5
    return octave(cuda, h, w), x, y, s, live


@pytest.mark.parametrize("mode", ["shift", "exact", "fast"])
def test_orient_desc_kernel_at_borders_and_both_patch_sizes(cuda, mode):
    img, x, y, s, live = border_keypoints(cuda)
    assert bool((s[live] <= 1.72).any()) and bool((s[live] > 1.72).any())
    before = orient_desc.KERNEL.launches
    got = orient_desc.orient_and_describe(img, x, y, s, live, mode)
    again = orient_desc.orient_and_describe(img, x, y, s, live, mode)
    torch.cuda.synchronize()
    assert orient_desc.KERNEL.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))        # bit-identical
    ref = orient_desc.orient_and_describe_plain(img, x, y, s, live, mode)
    dori = (got[2] - ref[2]).abs()
    dori = torch.minimum(dori, 360.0 - dori)[live]
    assert float(dori.median()) < 0.2 and float((dori < 2.0).float().mean()) >= 0.9
    assert float((got[4] == ref[4])[live].float().mean()) >= 0.9
    same = live & ((got[2] - ref[2]).abs() < 1e-3)
    assert int(same.sum()) >= 0.9 * int(live.sum())
    rowerr = (got[0] - ref[0]).abs().max(dim=1).values[same]
    assert float(rowerr.median()) < 4e-3 and float(rowerr.max()) < 2e-2
    both = same & got[4] & ref[4] & ((got[3] - ref[3]).abs() < 1e-3)
    assert int(both.sum()) > 5                                       # second descriptors too
    assert float((got[1] - ref[1]).abs().max(dim=1).values[both].max()) < 2e-2
    torch.testing.assert_close(got[0][live].norm(dim=1),
                               torch.ones(int(live.sum()), device=cuda), rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1][live & got[4]].norm(dim=1),
                               torch.ones(int((live & got[4]).sum()), device=cuda),
                               rtol=0, atol=1e-4)
    assert not got[0][~live].any() and not got[1][~(live & got[4])].any()
    assert not got[2][~live].any() and not got[3][~live].any() and not got[4][~live].any()


@pytest.mark.parametrize("mode", ["shift", "exact", "fast"])
def test_orient_desc_kernel_replays_in_a_graph(cuda, mode):
    """Captured once, replayed on new keypoints and a new live mask: every
    replay equals an eager call bit for bit."""
    img, x, y, s, live = border_keypoints(cuda)
    args = [t.clone() for t in (x, y, s, live)]
    orient_desc.orient_and_describe(img, *args, mode)    # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = orient_desc.orient_and_describe(img, *args, mode)
    g = torch.Generator(device=cuda).manual_seed(65)
    n = x.shape[0]
    for shift in (0.0, 11.3, 57.9):
        args[0].copy_((x + shift) % 300.0)
        args[1].copy_((y + 0.5 * shift) % 200.0)
        args[2].copy_(0.9 + 1.7 * torch.rand(n, device=cuda, generator=g))
        args[3].copy_(torch.rand(n, device=cuda, generator=g) < 0.8)
        graph.replay()
        eager = orient_desc.orient_and_describe(img, *args, mode)
        assert all(torch.equal(a, b) for a, b in zip(out, eager)), shift
        assert bool(out[4].any()) and not out[0][~args[3]].any()


def test_descriptor_kernel_replays_in_a_graph(cuda):
    """K7 captured once and replayed on new keypoints, orientations and
    counts, the count read on the device."""
    img, x, y, s, o, count = front_packed(cuda)
    args = [t.clone() for t in (x, y, s, o, count)]
    descriptor.extract_descriptors(img, *args)           # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = descriptor.extract_descriptors(img, *args)
    for shift, live in ((0.0, 50), (17.7, 64), (91.2, 0), (3.1, 1)):
        args[0].copy_((x + shift) % 300.0)
        args[3].copy_((o + 3.0 * shift) % 360.0)
        args[4].fill_(live)
        graph.replay()
        ref = descriptor.extract_descriptors_plain(img, *args)
        assert float((out - ref).abs().max()) <= 1e-5, (shift, live)
        assert torch.equal(out, descriptor.extract_descriptors(img, *args))
        assert not out[live:].any() and bool(out[:live].any()) == (live > 0)


def flip_case(cuda):
    """The JAX package's bfloat16 near-tie (tests/test_pallas.py): row 40
    wins in exact arithmetic, row 20 in the bfloat16x3 split."""
    q = np.full(128, 1.001, np.float32)

    def exact64(x):
        return float(q.astype(np.float64) @ x.astype(np.float64))

    cand_a = np.full(128, 1.0048125, np.float32)
    cand_a[:30] = np.float32(0.997)
    cand_b = np.full(128, 1.003, np.float32)
    diff = exact64(cand_a) - exact64(cand_b)
    cand_b[:100] += np.float32((diff + 1e-4) / 1.001 / 100)
    d2 = np.random.default_rng(7).standard_normal((64, 128)).astype(np.float32) * 0.01
    d2[20] = cand_a
    d2[40] = cand_b
    return (torch.as_tensor(np.stack([q] * 8), device=cuda), torch.as_tensor(d2, device=cuda))


@pytest.mark.parametrize("use_bf16", [False, True])
def test_match_kernel_matches_plain(cuda, use_bf16):
    # Capacities that are whole multiples of neither the kernel's 64-row
    # blocks nor its 1024-column ranges; n2 ending inside a range and a
    # tile, at a range's end, at 0; n1 at 0.
    g = torch.Generator(device=cuda).manual_seed(53)
    d1 = torch.nn.functional.normalize(torch.randn(700, 128, device=cuda, generator=g), dim=1)
    d2 = torch.nn.functional.normalize(torch.randn(2500, 128, device=cuda, generator=g), dim=1)
    d2[[11, 40]] = d1[3]                          # a tie: lowest index wins
    for n1, n2 in ((700, 2500), (650, 601), (700, 1100), (633, 2048), (700, 0), (0, 2500)):
        before = match.KERNEL.launches
        got = match.match_descriptors(d1, d2, n1, n2, use_bf16=use_bf16)
        assert match.KERNEL.launches == before + 1
        ref = match_plain.match_descriptors(d1, d2, n1, n2, use_bf16=use_bf16)
        assert torch.equal(got[2], ref[2]), (n1, n2)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-5)
        assert not got[0][n1:].any() and not got[2][n1:].any()
    assert int(match.match_descriptors(d1, d2, 700, 900, use_bf16=use_bf16)[2][3]) == 11
    if not use_bf16:      # the exact tier keeps the near-tie's exact winner
        fd1, fd2 = flip_case(cuda)
        assert match.match_descriptors(fd1, fd2, 8, 64)[2].tolist() == [40] * 8


def test_pipeline_on_card_matches_cpu(cuda):
    img = make_test_image(192, 256, seed=54)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    on_gpu = ct.extract_sift(torch.as_tensor(img, device=cuda), params)
    again = ct.extract_sift(torch.as_tensor(img, device=cuda), params)
    on_cpu = ct.extract_sift(img, params, device="cpu")
    n = int(on_cpu.num_pts)
    assert int(on_gpu.num_pts) == n and n > 30
    torch.testing.assert_close(on_gpu.xpos.cpu(), on_cpu.xpos, rtol=1e-5, atol=1e-4)
    assert torch.equal(on_gpu.data, again.data)
    with pytest.raises(NotImplementedError):
        ct.extract_sift(torch.as_tensor(img, device=cuda), ct.SiftParams(use_pallas=False))


def test_compact_kernel_matches_plain(cuda):
    _, m = dog.dog_and_mask(octave(cuda), laplace_kernels(1)[0], 2.0, 10.0)
    g = torch.Generator(device=cuda).manual_seed(55)
    dense = torch.rand((5, 67, 251), device=cuda, generator=g) < 0.3
    big = torch.rand((3 * compact.SEGMENT,), device=cuda, generator=g) < 0.01
    seg1 = compact.SEGMENT + 1
    cases = [(m, 512), (m, 8), (dense, 4096), (dense, 70000),
             (torch.zeros((5, 9, 9), dtype=torch.bool, device=cuda), 128),     # nothing set
             (torch.ones((5, 67, 121), dtype=torch.bool, device=cuda), 50000),  # all set
             (torch.ones((seg1,), dtype=torch.bool, device=cuda), 1024),        # saturating
             (big[3:], 1024), (big[1:seg1 + 1], 512), (big[15:31], 64)]         # unaligned views
    cases += [(big[:n], 64) for n in (1, 15, 16, 17, seg1)]
    cases += [(torch.ones((n,), dtype=torch.bool, device=cuda), 64) for n in (1, 15, 16, 17)]
    for mask, cap in cases:
        before = compact.KERNEL.launches
        got = compact.compact_mask(mask, cap)
        ref = detect.compact_mask(mask, cap, with_total=True)
        assert compact.KERNEL.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), (tuple(mask.shape), cap)
    assert int(got[2]) == 17 and int(compact.compact_mask(cases[6][0], 1024)[2]) == seg1


def test_compact_kernel_replays_in_a_graph(cuda):
    """Captured once, replayed on new mask contents: no state outlives a
    call, so every replay equals the plain version."""
    mask = torch.zeros((5, 135, 241), dtype=torch.bool, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(64)
    compact.compact_mask(mask, 2048)                     # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = compact.compact_mask(mask, 2048)
    for density in (0.001, 0.2, 0.0, 0.01):
        mask.copy_(torch.rand(mask.shape, device=cuda, generator=g) < density)
        graph.replay()
        ref = detect.compact_mask(mask, 2048, with_total=True)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), density


def test_graph_timer_on_the_card(cuda):
    from cudasift_tpu_torch.utils.timers import time_ms_graph

    img = octave(cuda)
    taps = laplace_kernels(1)[0]
    assert time_ms_graph(dog.dog_and_mask, img, taps, 2.0, 10.0, n=5) > 0
    _, m = dog.dog_and_mask(img, taps, 2.0, 10.0)
    assert time_ms_graph(compact.compact_mask, m, 512, n=5) > 0


def front_packed(cuda, n=64, live=50):
    img = octave(cuda)
    rng = np.random.default_rng(56)
    # Positions reach past the left/top patch margins and the image box.
    x = torch.tensor(rng.uniform(-1, 300, n), dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.uniform(-1, 200, n), dtype=torch.float32, device=cuda)
    s = torch.tensor(rng.uniform(0.9, 2.4, n), dtype=torch.float32, device=cuda)
    o = torch.tensor(rng.uniform(0, 360, n), dtype=torch.float32, device=cuda)
    return img, x, y, s, o, torch.tensor(live, dtype=torch.int32, device=cuda)


def test_orient_kernel_matches_plain(cuda):
    img, x, y, s, _, count = front_packed(cuda)
    got = orient.orientation_histograms(img, x, y, s, count)
    ref = orient.orientation_histograms_plain(img, x, y, s, count)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert not got[50:].any() and bool((got[:50].sum(dim=1) > 0).all())
    assert torch.equal(got, orient.orientation_histograms(img, x, y, s, count))


def border_front_packed(cuda, h, w):
    """Front-packed keypoints within 7 px of every border and corner, past
    the image box on every side, and in the interior."""
    edge_x = [-3.4, -0.6, 0.0, 0.4, 3.3, 5.99, 6.9, 7.0, w - 7.2, w - 3.5, w - 1.0, w - 0.3, w + 2.6]
    edge_y = [-2.2, -0.6, 0.0, 0.4, 3.3, 5.99, 6.9, 7.0, h - 7.2, h - 3.5, h - 1.0, h - 0.3, h + 4.1]
    pts = [(x, y) for x in edge_x for y in (2.5, h / 2 + 0.25, h - 2.5)]
    pts += [(x, y) for y in edge_y for x in (2.5, w / 2 + 0.75, w - 2.5)]
    pts += [(x, y) for x in (0.0, w - 1.0) for y in (0.0, h - 1.0)]
    pts += [(w / 3, h / 3), (w / 2 + 0.5, h / 2 + 0.5), (2 * w / 3 + 0.1, 2 * h / 3 + 0.9)]
    x = torch.tensor([p[0] for p in pts], dtype=torch.float32, device=cuda)
    y = torch.tensor([p[1] for p in pts], dtype=torch.float32, device=cuda)
    s = torch.tensor(np.random.default_rng(67).uniform(0.9, 2.6, len(pts)), dtype=torch.float32,
                     device=cuda)
    return octave(cuda, h, w), x, y, s


@pytest.mark.parametrize("h,w", [(200, 300), (67, 121), (17, 9), (5, 40), (1080, 1920)])
def test_orient_kernel_peaks_match_plain(cuda, h, w):
    """K6 with its peak search inside, at ragged and tiny shapes, with the
    count at 0, inside and at the capacity: histograms as the plain version
    gives them (only the order of a bin's sum differs), the peaks those of
    ``histogram_peaks`` on the kernel's own histograms, zeros past the count,
    two runs bit-identical, and the histogram-only entry the same bits."""
    img, x, y, s = border_front_packed(cuda, h, w)
    n = x.shape[0]
    for count in (0, 1, n // 2, n):
        c = torch.tensor(count, dtype=torch.int32, device=cuda)
        before = orient.KERNEL.launches
        hist, p1, p2, h2 = orient.orientation_peaks(img, x, y, s, c)
        assert orient.KERNEL.launches == before + 1
        ref = orient.orientation_peaks_plain(img, x, y, s, c)
        torch.testing.assert_close(hist, ref[0], rtol=1e-5, atol=1e-5)
        q1, q2, g2 = orient_plain.histogram_peaks(hist)
        torch.testing.assert_close(p1[:count], q1[:count], rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(p2[:count], q2[:count], rtol=1e-6, atol=1e-5)
        assert torch.equal(h2[:count], g2[:count])
        for t in (hist, p1, p2, h2):
            assert not t[count:].any()
        again = orient.orientation_peaks(img, x, y, s, c)
        assert all(torch.equal(a, b) for a, b in zip((hist, p1, p2, h2), again))
        assert torch.equal(hist, orient.orientation_histograms(img, x, y, s, c))
    assert bool((hist.sum(dim=1) > 0).any()) and bool(h2.any()) and not bool(h2.all())


def test_launch_floor_kernel(cuda):
    from cudasift_tpu_torch.utils.timers import time_ms_graph

    before = probes.LAUNCH_FLOOR.launches
    probes.launch_floor(cuda)
    probes.launch_floor(cuda, 160, 32)
    torch.cuda.synchronize()
    assert probes.LAUNCH_FLOOR.launches == before + 2
    assert 0 < time_ms_graph(probes.launch_floor, cuda, 1280, 128, n=20) < 1.0
    with pytest.raises(RuntimeError):
        probes.LAUNCH_FLOOR(cuda, 1, 2048)            # the launcher refuses; nothing is counted
    assert probes.LAUNCH_FLOOR.launches == before + 2 + 23


def test_descriptor_kernel_matches_plain(cuda):
    img, x, y, s, o, count = front_packed(cuda)
    got = descriptor.extract_descriptors(img, x, y, s, o, count)
    ref = descriptor.extract_descriptors_plain(img, x, y, s, o, count)
    assert float((got - ref).abs().max()) <= 1e-5
    torch.testing.assert_close(got[:50].norm(dim=1), torch.ones(50, device=cuda),
                               rtol=0, atol=1e-4)
    assert not got[50:].any()
    assert torch.equal(got, descriptor.extract_descriptors(img, x, y, s, o, count))


def test_sweep_kernel_matches_plain(cuda):
    # 300 rows (not a multiple of 64), 2500 columns: 10 chunks in three
    # 1024-column ranges, the last one short; n2 ending inside a chunk and
    # a range, at 1 and at 0; n1 at 0.
    g = torch.Generator(device=cuda).manual_seed(57)
    d1 = torch.nn.functional.normalize(torch.randn(300, 128, device=cuda, generator=g), dim=1)
    d2 = torch.nn.functional.normalize(torch.randn(2500, 128, device=cuda, generator=g), dim=1)
    d2[[40, 2100]] = d1[5]                     # a tie across chunks: lowest index wins
    for n1, n2 in ((300, 2500), (270, 1901), (257, 1100), (300, 1), (300, 0), (0, 2500)):
        before = match.SWEEP_KERNEL.launches
        got = match.match_descriptors(d1, d2, n1, n2, rescore_k=8)
        assert match.SWEEP_KERNEL.launches == before + 1
        ref = match_plain.match_descriptors_hybrid(d1, d2, n1, n2, 8)
        assert torch.equal(got[2], ref[2]), (n1, n2)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=1e-7)
        exact = match.match_descriptors(d1, d2, n1, n2)
        assert torch.equal(got[2], exact[2])
        torch.testing.assert_close(got[0], exact[0], rtol=0, atol=1e-5)
    assert int(match.match_descriptors(d1, d2, 300, 2500, rescore_k=8)[2][5]) == 40
    for n1, n2 in ((270, 1901), (300, 0), (0, 2500)):
        cs, ci = match.sweep_candidates(d1, d2, n1, n2)
        ps, pi = match_plain.sweep_candidates(d1, d2, n1, n2)
        assert torch.equal(ci, pi), (n1, n2)
        torch.testing.assert_close(cs, ps, rtol=1e-6, atol=1e-7)
    fd1, fd2 = flip_case(cuda)                 # the sweep is fooled, the rescore is not
    assert match.sweep_candidates(fd1, fd2, 8, 64)[1][0, :2].tolist() == [20, 40]
    assert match.match_descriptors(fd1, fd2, 8, 64, rescore_k=8)[2].tolist() == [40] * 8


@pytest.mark.parametrize("use_pallas_compact", [False, True])
def test_split_pipeline_on_card_matches_cpu(cuda, use_pallas_compact):
    img = make_test_image(192, 256, seed=58)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048, use_fused=False,
                           use_pallas_compact=use_pallas_compact)
    counts = {k: k.launches for k in (compact.KERNEL, orient.KERNEL, descriptor.KERNEL,
                                      orient_desc.KERNEL)}
    on_gpu = ct.extract_sift(torch.as_tensor(img, device=cuda), params)
    again = ct.extract_sift(torch.as_tensor(img, device=cuda), params)
    launched = {k.name: k.launches - c for k, c in counts.items()}
    assert launched["orient"] == launched["descriptor"] == 6 and launched["orient_desc"] == 0
    assert launched["compact"] == (6 if use_pallas_compact else 0)
    on_cpu = ct.extract_sift(img, params, device="cpu")
    n = int(on_cpu.num_pts)
    assert int(on_gpu.num_pts) == n and n > 30
    torch.testing.assert_close(on_gpu.xpos.cpu(), on_cpu.xpos, rtol=1e-5, atol=1e-4)
    assert torch.equal(on_gpu.data, again.data)


def test_acquire_kernels_match_plain(cuda):
    img, oy, ox, rxy = acquire.bench_inputs(256, 200, 640, seed=59)
    edge = (np.arange(64 * 300, dtype=np.float32).reshape(64, 300) % 97,
            np.array([0, 8, 16, 60, -5, 0, 3, 8], np.int32),
            np.array([0, 128, 44, 250, 0, -9, 7, 0], np.int32),
            np.array([0, 7, 60, -3, 2, 9, 1, 55, 0, 127, 300, -1, 5, 200, 3, 250], np.int32))
    for arrays in ((img, oy, ox, rxy), edge):
        args = tuple(torch.as_tensor(a, device=cuda) for a in arrays)
        for name, staged, roll in acquire.VARIANTS:
            kern = acquire.KERNELS[(staged, roll)]
            before = kern.launches
            got = acquire.acquire(*args, staged=staged, roll=roll)
            assert kern.launches == before + 1, name
            ref = acquire.acquire_plain(*args, roll)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=0, msg=name)
            assert not got[:, 1:].any()


def acquire_case(case, cuda):
    """P1 inputs for each of the kernels' branches, on the card: the bench's
    own (one TMA box a keypoint); origins from before the image to past it
    with realignments over the whole patch (wrapped windows of up to four
    pieces, pieces inside and outside the image); windows that each wrap
    into four pieces inside the image, 32 TMA boxes a block with the rolls,
    so the staged kernel refills its eight slots in four rounds; the random
    case again on an image of odd width and on a view whose base is 4 bytes
    past a 16-byte boundary (no TMA: every piece takes the clamped branch in
    the staged kernel). Values in [0, 1), so the sums are far from 0 and
    rtol is meaningful."""
    if case == "bench":
        img, oy, ox, rxy = acquire.bench_inputs(2048, 1080, 1920, seed=0)
    elif case == "rounds":
        h, w, n = 130, 420, 32
        rng = np.random.default_rng(69)
        img = rng.random((h, w), dtype=np.float32)
        oy = rng.integers(0, h - acquire.PR + 1, n).astype(np.int32)
        ox = rng.integers(0, w - acquire.PWR + 1, n).astype(np.int32)
        rxy = np.concatenate([rng.integers(9, 56, n), rng.integers(193, 256, n)]).astype(np.int32)
    else:
        h, w = (97, 301) if case == "odd_width" else (130, 420)
        rng = np.random.default_rng(67)
        n = 256
        img = rng.random((h, w), dtype=np.float32)
        oy = rng.integers(-60, h + 8, n).astype(np.int32)
        ox = rng.integers(-260, w + 8, n).astype(np.int32)
        rxy = np.concatenate([rng.integers(0, 56, n), rng.integers(0, 256, n)]).astype(np.int32)
    if case == "unaligned":
        flat = torch.empty(img.size + 1, dtype=torch.float32, device=cuda)
        img_t = flat[1:].view(img.shape)
        img_t.copy_(torch.as_tensor(img))
    else:
        img_t = torch.as_tensor(img, device=cuda)
    return (img_t,) + tuple(torch.as_tensor(a, device=cuda) for a in (oy, ox, rxy))


@pytest.mark.parametrize("case", ["bench", "wrap_clamp", "rounds", "odd_width", "unaligned"])
def test_acquire_kernels_match_plain_on_every_branch(cuda, case):
    args = acquire_case(case, cuda)
    h, w = args[0].shape
    assert (args[0].data_ptr() % 16 != 0) == (case == "unaligned")
    for name, staged, roll in acquire.VARIANTS:
        boxes = acquire.window_boxes(*args[1:], roll, h, w,
                                     base_aligned=args[0].data_ptr() % 16 == 0)
        on_tma = [b.tma for kp in boxes for b in kp]
        if case == "bench":
            assert all(on_tma) and len(on_tma) == len(boxes)
        elif case == "wrap_clamp":
            assert any(on_tma) and not all(on_tma)
            assert max(map(len, boxes)) == (4 if roll else 1)
        elif case == "rounds":
            assert all(on_tma) and len(on_tma) == len(boxes) * (4 if roll else 1)
        else:
            assert not any(on_tma)
        kern = acquire.KERNELS[(staged, roll)]
        before = kern.launches
        tma = torch.zeros(1, dtype=torch.int32, device=cuda)
        got = acquire.acquire(*args, staged=staged, roll=roll, tma_pieces=tma)
        assert kern.launches == before + 1, name
        # The kernel's own count of the boxes that arrived by TMA.
        assert int(tma) == (sum(on_tma) if staged else 0), name
        ref = acquire.acquire_plain(*args, roll)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0, msg=f"{case}, {name}")
        assert not got[:, 1:].any()


@pytest.mark.parametrize("case", ["wrap_clamp", "rounds"])
def test_acquire_replays_in_a_graph(cuda, case):
    """Each P1 launcher captured once (the staged one with its tensor map
    by value) replays the eager call bit for bit, and again after the
    image's contents change under the same address."""
    args = acquire_case(case, cuda)
    img = args[0]
    for name, staged, roll in acquire.VARIANTS:
        eager = acquire.acquire(*args, staged, roll)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = acquire.acquire(*args, staged, roll)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), name
        saved = img.clone()
        img.mul_(0.5).add_(0.25)
        graph.replay()
        assert torch.equal(out, acquire.acquire(*args, staged, roll)), name
        img.copy_(saved)


def test_probe_kernels_pass_and_match_plain(cuda):
    for p in probes.PROBES:
        args = p.inputs(cuda)
        before = p.kernel.launches
        out = p.fn(*args)
        assert p.kernel.launches == before + 1, p.name
        ok, err = p.judge(out.cpu().numpy(), args)
        assert ok, (p.name, err)
        torch.testing.assert_close(out, p.plain(*args), rtol=0, atol=1e-3, msg=p.name)
    assert all(ok for ok, _ in probes.run_probes(cuda).values())


def test_redesigned_probes_off_the_probe_shapes(cuda):
    """The four redesigned probes where their shapes leave the probe's:
    word and element paths, clamped offsets, a k tail and several tiles and
    k chunks, against their plain versions (0 apart, or 1e-3 for the two
    products)."""
    rng = np.random.default_rng(68)

    def t(shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)

    for cols in (128, 37):
        img = t((64, cols))
        for off in (-3, 0, 29, 60, 70):
            o = torch.tensor([off], dtype=torch.int32, device=cuda)
            assert torch.equal(probes.slice_rows(img, o), probes.slice_rows_plain(img, o))
        x = t((len(range(2, 50, 5)), cols))
        assert torch.equal(probes.strided_rows(x, 50, 2, 5), probes.strided_rows_plain(x, 50, 2, 5))
    for n, k in ((72, 272), (8, 16), (16, 512)):
        a, b = t((16, k), torch.bfloat16), t((n, k), torch.bfloat16)
        torch.testing.assert_close(probes.lane_lane_dot(a, b), probes.lane_lane_dot_plain(a, b),
                                   rtol=0, atol=1e-3)
    for m, k, n in ((20, 260, 36), (1, 4, 4), (33, 1024, 128), (4, 6, 5), (17, 301, 37)):
        a, b = t((m, k)), t((k, n))
        torch.testing.assert_close(probes.small_dot(a, b), probes.small_dot_plain(a, b),
                                   rtol=0, atol=1e-3)


def test_redesigned_probes_on_views_off_16_bytes(cuda):
    """The four redesigned probes on views whose base lies 4, 8 or 12 bytes
    past a 16-byte boundary: their address-aligned 16-byte loads take a
    second word, the result is the plain version's. ``lane_lane_dot`` reads
    bf16 pairs, so a base off 4 bytes is refused."""
    rng = np.random.default_rng(70)

    def view(shape, skip, dtype=torch.float32):
        flat = torch.empty(int(np.prod(shape)) + skip, dtype=dtype, device=cuda)
        v = flat[skip:].view(shape)
        v.copy_(torch.as_tensor(rng.standard_normal(shape), dtype=dtype))
        return v

    for skip in (1, 2, 3):
        for cols in (128, 37):
            img = view((64, cols), skip)
            assert img.data_ptr() % 16 == 4 * skip
            o = torch.tensor([5], dtype=torch.int32, device=cuda)
            assert torch.equal(probes.slice_rows(img, o), probes.slice_rows_plain(img, o))
            x = view((16, cols), skip)
            assert torch.equal(probes.strided_rows(x, 128, 3, 8),
                               probes.strided_rows_plain(x, 128, 3, 8))
        a, b = view((16, 256), skip), view((256, 128), skip)
        torch.testing.assert_close(probes.small_dot(a, b), probes.small_dot_plain(a, b),
                                   rtol=0, atol=1e-3)
    for skip in (2, 4, 6):
        a, b = view((16, 256), skip, torch.bfloat16), view((16, 256), 8 - skip, torch.bfloat16)
        torch.testing.assert_close(probes.lane_lane_dot(a, b), probes.lane_lane_dot_plain(a, b),
                                   rtol=0, atol=1e-3)
    with pytest.raises(ValueError):
        probes.lane_lane_dot(view((16, 256), 1, torch.bfloat16), view((16, 256), 0, torch.bfloat16))


def test_fast_pipeline_on_card_matches_cpu(cuda):
    img = make_test_image(192, 256, seed=60)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048, fast_gradients=True)
    before = orient_desc.KERNEL.launches
    on_gpu = ct.extract_sift(img, params)                 # an array goes to the card
    assert on_gpu.device.type == "cuda" and orient_desc.KERNEL.launches == before + 3
    on_cpu = ct.extract_sift(img, params, device="cpu")
    n = int(on_cpu.num_pts)
    assert int(on_gpu.num_pts) == n and n > 30
    torch.testing.assert_close(on_gpu.xpos.cpu(), on_cpu.xpos, rtol=1e-5, atol=1e-4)
    row = (on_gpu.data.cpu() - on_cpu.data).abs().max(dim=1).values[:n]
    assert float(row.median()) < 4e-3


def test_cli_on_card(cuda, tmp_path, capsys):
    h, w = 320, 480
    a = synth.make_leaves_image(h, w, seed=0)
    left, right = str(tmp_path / "l.pgm"), str(tmp_path / "r.pgm")
    io.write_pgm(left, a)
    io.write_pgm(right, synth.warp_image(a, synth.known_homography(h, w)))
    out = str(tmp_path / "annotated.pgm")
    before = {k: k.launches for k in FUSED_PATH}
    assert cli.main(["--left", left, "--right", right, "--octaves", "3", "--max-pts", "2048",
                     "--num-loops", "512", "--json", "--time", "--out", out]) == 0
    assert all(k.launches > before[k] for k in FUSED_PATH)
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_pts1"] > 100 and metrics["overflow1"] == 0 and metrics["num_fit"] > 50
    assert metrics["extract_ms"] > 0 and metrics["match_ms"] > 0
    assert io.read_pgm(out).shape == (h, w)


# ---- The entry points as captured programs (utils.jit) ----------------------

def assert_sift_equal(a, b, what=""):
    for name in ct.SiftData.__dataclass_fields__:
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)


FLOWS = {
    "shift": dict(),
    "fast": dict(fast_gradients=True),
    "exact": dict(grad_mode="exact"),
    "split": dict(use_fused=False),
    "split_k8": dict(use_fused=False, use_pallas_compact=True),
    "scale_up": dict(scale_up=True),
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_graph_equals_eager(cuda, flow):
    """The first call (eager, then captured), a replay and a replay on a
    second image of the same shape each equal the eager run of that image
    field by field, and count the same launches."""
    pipeline._extract_sift_jit.clear_cache()
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048, **FLOWS[flow])
    imgs = [torch.as_tensor(make_test_image(192, 256, seed=s), device=cuda) for s in (70, 71)]
    with jit.disable_graphs():
        eager = [ct.extract_sift(i, params) for i in imgs]
        for k in LIBRARY:
            k.launches = 0
        ct.extract_sift(imgs[0], params)
        eager_launches = {k.name: k.launches for k in LIBRARY}
    assert not pipeline._extract_sift_jit.programs
    assert int(eager[0].num_pts) > 30 and not torch.equal(eager[0].xpos, eager[1].xpos)
    for call, which in (("first", 0), ("replay", 0), ("second image", 1), ("back", 0)):
        for k in LIBRARY:
            k.launches = 0
        got = ct.extract_sift(imgs[which], params)
        torch.cuda.synchronize()
        assert_sift_equal(got, eager[which], (flow, call))
        assert {k.name: k.launches for k in LIBRARY} == eager_launches, (flow, call)
    assert len(pipeline._extract_sift_jit.programs) == 1
    assert sum(eager_launches.values()) >= 9


def test_graph_programs_per_shape_and_held_results(cuda):
    pipeline._extract_sift_jit.clear_cache()
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    a = torch.as_tensor(make_test_image(192, 256, seed=72), device=cuda)
    b = torch.as_tensor(make_test_image(160, 224, seed=73), device=cuda)
    c = torch.as_tensor(make_test_image(192, 256, seed=74), device=cuda)
    with jit.disable_graphs():
        ea, eb, ec = (ct.extract_sift(i, params) for i in (a, b, c))
    for _ in range(2):
        ra = ct.extract_sift(a, params)
        rb = ct.extract_sift(b, params)
    assert len(pipeline._extract_sift_jit.programs) == 2       # two shapes, two programs
    held = ct.extract_sift(a, params)                           # a replay's result
    rc = ct.extract_sift(c, params)                             # the same program again
    torch.cuda.synchronize()
    assert_sift_equal(held, ea, "held")
    assert_sift_equal(ra, ea, "a")
    assert_sift_equal(rb, eb, "b")
    assert_sift_equal(rc, ec, "c")
    assert held.data.data_ptr() != rc.data.data_ptr()
    # Other params: another program.
    other = ct.SiftParams(num_octaves=3, thresh=2.5, max_pts=2048)
    ct.extract_sift(a, other)
    assert len(pipeline._extract_sift_jit.programs) == 3
    pipeline._extract_sift_jit.clear_cache()
    assert not pipeline._extract_sift_jit.programs


def test_graph_calls_from_two_streams_are_ordered(cuda):
    """One program called back to back from two streams with nothing between
    them but the program's own event: each call gives its own image's result."""
    pipeline._extract_sift_jit.clear_cache()
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    imgs = [torch.as_tensor(make_test_image(192, 256, seed=s), device=cuda) for s in (72, 74)]
    with jit.disable_graphs():
        eager = [ct.extract_sift(i, params) for i in imgs]
    ct.extract_sift(imgs[0], params)                            # eager, then captured
    torch.cuda.synchronize()                                    # the images exist for every stream
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for turn in range(6):
        with torch.cuda.stream(streams[turn % 2]):
            got.append(ct.extract_sift(imgs[turn % 2], params))
    torch.cuda.synchronize()
    for turn, d in enumerate(got):
        assert_sift_equal(d, eager[turn % 2], ("stream", turn))
    assert len(pipeline._extract_sift_jit.programs) == 1
    pipeline._extract_sift_jit.clear_cache()


def test_graph_oldest_program_goes(cuda, monkeypatch):
    monkeypatch.setattr(jit, "MAX_PROGRAMS", 2)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    a = torch.as_tensor(make_test_image(192, 256, seed=72), device=cuda)
    b = torch.as_tensor(make_test_image(160, 224, seed=73), device=cuda)
    small = jit.cuda_graph_jit(pipeline._extract)
    for img in (a, b, a, a[:100].contiguous()):
        last = small(img, params)
    assert len(small.programs) == 2
    assert (tuple(b.shape), torch.float32) not in [k[1] for k in small.programs]
    small.clear_cache()
    torch.cuda.synchronize()
    with jit.disable_graphs():
        assert_sift_equal(last, small(a[:100].contiguous(), params), "held past the drop")


def test_throughput_program_equals_single_calls(cuda):
    pipeline._extract_batch_jit.clear_cache()
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    frames = torch.stack([torch.as_tensor(make_test_image(192, 256, seed=s), device=cuda)
                          for s in (75, 76, 77, 78)])
    with jit.disable_graphs():
        singles = [ct.extract_sift(f, params) for f in frames]
    for k in LIBRARY:
        k.launches = 0
    first = ct.extract_sift_throughput(frames, params)
    per_call = {k.name: k.launches for k in LIBRARY}
    again = ct.extract_sift_throughput(frames, params)
    flipped = ct.extract_sift_throughput(frames.flip(0), params)
    torch.cuda.synchronize()
    assert per_call["dog"] == per_call["refine"] == per_call["orient_desc"] == 12
    assert {k.name: k.launches for k in LIBRARY} == {n: 3 * c for n, c in per_call.items()}
    assert len(pipeline._extract_batch_jit.programs) == 1
    assert first.num_pts.shape == (4,) and first.data.shape == (4, 2048, 128)
    for i, single in enumerate(singles):
        for name in ct.SiftData.__dataclass_fields__:
            assert torch.equal(getattr(first, name)[i], getattr(single, name)), (i, name)
            assert torch.equal(getattr(again, name)[i], getattr(single, name)), (i, name)
            assert torch.equal(getattr(flipped, name)[3 - i], getattr(single, name)), (i, name)


def test_graph_capture_failure_raises(cuda):
    """A body that waits for the host cannot be captured: the call raises
    and keeps no program."""
    @jit.cuda_graph_jit
    def bad(x):
        return x + float(x.sum())            # a host read inside the body

    x = torch.ones(8, device=cuda)
    with pytest.raises(RuntimeError):
        bad(x)
    torch.cuda.synchronize()
    assert not bad.programs
    with jit.disable_graphs():
        assert float(bad(x)[0]) == 9.0


# ---- K4's second output; RANSAC and IRLS as captured programs; parallel -----

@pytest.mark.parametrize("use_bf16", [False, True])
def test_match_kernel_second_output(cuda, use_bf16):
    """K4 with its second-best output against the plain triple; the call
    without it (a null pointer) gives the same score, ambiguity and index bit
    for bit, and ambiguity is second / (score + 1e-6) to the bit."""
    g = torch.Generator(device=cuda).manual_seed(55)
    d1 = torch.nn.functional.normalize(torch.randn(700, 128, device=cuda, generator=g), dim=1)
    d2 = torch.nn.functional.normalize(torch.randn(2500, 128, device=cuda, generator=g), dim=1)
    for n1, n2 in ((700, 2500), (650, 601), (700, 0), (0, 2500)):
        before = match.KERNEL.launches
        best, second, index = match.match_top2(d1, d2, n1, n2, use_bf16=use_bf16)
        score, amb, idx = match.match_descriptors(d1, d2, n1, n2, use_bf16=use_bf16)
        assert match.KERNEL.launches == before + 2
        ref = match_plain.match_top2(d1, d2, n1, n2, use_bf16=use_bf16)
        assert torch.equal(index, ref[2]), (n1, n2)
        torch.testing.assert_close(best, ref[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(second, ref[1], rtol=1e-5, atol=1e-6)
        assert torch.equal(best, score) and torch.equal(index, idx)
        assert torch.equal(amb, second / (best + 1e-6))
        assert not second[n1:].any()


def matched_flow(cuda, seed=80):
    """A small dead-leaves pair through extraction and the matcher, and its
    true homography."""
    h, w = 240, 320
    frame = synth.make_leaves_image(h, w, seed)
    h_true = synth.known_homography(h, w)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    da = ct.extract_sift(torch.as_tensor(frame, device=cuda), params)
    db = ct.extract_sift(torch.as_tensor(synth.warp_image(frame, h_true), device=cuda), params)
    return da, db, h_true


def test_match_and_homography_programs_equal_eager(cuda):
    """``find_homography`` and ``improve_homography`` behind the eager
    ``match_sift_data``: the first call (eager, then captured), replays, a
    replay on another pair and one at other thresholds each equal the eager
    run bit for bit, with equal launch counts; the generator advances as in
    the eager run."""
    from cudasift_tpu_torch.ops import homography

    progs = (homography._find_homography_jit, homography._improve_homography_jit)
    for p in progs:
        p.clear_cache()
    pairs = [matched_flow(cuda, s)[:2] for s in (80, 81)]
    gen = torch.Generator(device=cuda)

    def flow(da, db, thresh=5.0):
        gen.manual_seed(3)
        m = ct.match_sift_data(da, db)
        h1, nm = ct.find_homography(m, gen, num_loops=2048, min_score=0.0,
                                    max_ambiguity=0.9, thresh=thresh)
        h2, nfit, err = ct.improve_homography(m, h1, 5, 0.0, 0.9, thresh - 2.0)
        after = torch.rand(2, generator=gen, device=cuda)
        return (m, h1, nm, h2, nfit, err, after)

    def counted(fn, *args):
        for k in LIBRARY:
            k.launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        return out, {k.name: k.launches for k in LIBRARY}

    args = [pairs[0], pairs[1], pairs[0] + (4.0,)]
    with jit.disable_graphs():
        eager = [counted(flow, *a) for a in args]
    assert not any(p.programs for p in progs)
    assert eager[0][1]["match"] == 1 and int(eager[0][0][4]) > 50
    for call, which in (("first", 0), ("replay", 0), ("other pair", 1), ("thresholds", 2),
                        ("back", 0)):
        got, launches = counted(flow, *args[which])
        ref, ref_launches = eager[which]
        assert launches == ref_launches, call
        assert_sift_equal(got[0], ref[0], call)
        for a, b in zip(got[1:], ref[1:]):
            assert torch.equal(a, b), call
    assert all(len(p.programs) == 1 for p in progs)


def assert_scoring_kernel_matches_plain(h8, fields, num_pts, thresh):
    """The kernel against its plain version on the card: counts equal, MSAC
    sums to 1e-5 with the same argmin, one launch; NaN poured into the point
    fields past ``num_pts`` changes no bit (no dead column is read)."""
    before = ransac.SCORE_KERNEL.launches
    counts, msac = ransac.inlier_counts(h8, *fields, num_pts, thresh)
    ref_counts, ref_msac = ransac.inlier_counts_plain(h8, *fields, num_pts, thresh)
    torch.cuda.synchronize()
    assert ransac.SCORE_KERNEL.launches == before + 1
    assert torch.equal(counts, ref_counts)
    torch.testing.assert_close(msac, ref_msac, rtol=1e-5, atol=0)
    assert int(torch.argmin(msac)) == int(torch.argmin(ref_msac))
    n = int(num_pts)
    poured = [f.clone() for f in fields]
    for f in poured:
        f[n:] = float("nan")
    got = ransac.inlier_counts(h8, *poured, num_pts, thresh)
    assert torch.equal(got[0], counts) and torch.equal(got[1], msac)
    return counts, msac


@pytest.mark.parametrize("num_h,num_pts,plant", scoring_cases.CASES, ids=scoring_cases.IDS)
def test_scoring_kernel_matches_plain(cuda, num_h, num_pts, plant):
    h8, fields = scoring_cases.scoring_case(num_h, num_pts, plant)
    assert_scoring_kernel_matches_plain(
        torch.tensor(h8, device=cuda), [torch.tensor(f, device=cuda) for f in fields],
        torch.tensor(num_pts, dtype=torch.int32, device=cuda),
        torch.tensor(5.0, device=cuda))


def test_scoring_kernel_on_the_1080p_pair_flow(cuda, monkeypatch):
    """The 10000 hypotheses RANSAC scores on a 1920x1080 dead-leaves pair at
    the benchmark's settings, taken from the eager program as it calls the
    scoring, against the plain version; captured, the scoring is two kernel
    nodes (the two of ``csrc/ransac_score.cu``) and nothing else, so no
    PyTorch kernel runs in it."""
    from cudasift_tpu_torch.ops import homography

    h, w = 1080, 1920
    frame = synth.make_leaves_image(h, w, 61)
    params = ct.SiftParams(num_octaves=5, init_blur=1.0, thresh=3.0, max_pts=32768)
    da = ct.extract_sift(torch.as_tensor(frame, device=cuda), params)
    warped = synth.warp_image(frame, synth.known_homography(h, w))
    db = ct.extract_sift(torch.as_tensor(warped, device=cuda), params)
    m = ct.match_sift_data(da, db)
    calls = []

    def recorded(*args):
        calls.append(args)
        return ransac.inlier_counts(*args)

    monkeypatch.setattr(homography, "inlier_counts", recorded)
    with jit.disable_graphs():
        ct.find_homography(m, torch.Generator(device=cuda).manual_seed(7), num_loops=10000,
                           min_score=0.0, max_ambiguity=0.8, thresh=5.0)
    assert [c[0].shape[0] for c in calls] == [10000, 1]
    h8, *fields, num_pts, thresh = calls[0]
    assert 5000 < int(num_pts) < 32768
    counts, _ = assert_scoring_kernel_matches_plain(h8, fields, num_pts, thresh)
    assert int(counts.max()) > 1000
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ransac.inlier_counts(h8, *fields, num_pts, thresh)
        nodes = trace.capture_nodes()
    assert nodes == {"kernel": 2}, nodes


def test_scoring_kernel_in_the_ransac_program(cuda):
    """``find_homography`` launches the scoring kernel twice a call (the
    hypotheses and the refit's rescore), eager, capturing and replayed, and
    two replays give the eager run's bits."""
    from cudasift_tpu_torch.ops import homography

    homography._find_homography_jit.clear_cache()
    m = ct.match_sift_data(*matched_flow(cuda)[:2])
    gen = torch.Generator(device=cuda)

    def call():
        gen.manual_seed(3)
        before = ransac.SCORE_KERNEL.launches
        out = ct.find_homography(m, gen, num_loops=2048, min_score=0.0, max_ambiguity=0.9,
                                 thresh=5.0)
        torch.cuda.synchronize()
        return out, ransac.SCORE_KERNEL.launches - before

    with jit.disable_graphs():
        eager, launches = call()
    assert launches == 2
    for what in ("first", "replay", "replay again"):
        out, launches = call()
        assert launches == 2, what
        assert all(torch.equal(a, b) for a, b in zip(out, eager)), what
    assert len(homography._find_homography_jit.programs) == 1
    assert int(eager[1]) > 50


def refit_inputs(cuda, num_w, max_pts=32768, seed=90):
    """DLT rows of ``max_pts`` noisy pairs in Hartley scale under a
    homography, and ``num_w`` weightings in {0, 1} (about 70% of the rows
    each), float32 on the card."""
    rng = np.random.default_rng(seed)
    nx1, ny1 = rng.uniform(-1.5, 1.5, (2, max_pts))
    hm = np.array([[1.1, 0.05, 0.1], [-0.04, 0.9, -0.2], [0.05, -0.03, 1.0]])
    q = hm @ np.stack([nx1, ny1, np.ones(max_pts)])
    nx2, ny2 = q[:2] / q[2] + rng.normal(0, 1e-3, (2, max_pts))
    one, zero = np.ones(max_pts), np.zeros(max_pts)
    ya = np.stack([nx1, ny1, one, zero, zero, zero, -nx1 * nx2, -ny1 * nx2], 1)
    yb = np.stack([zero, zero, zero, nx1, ny1, one, -nx1 * ny2, -ny1 * ny2], 1)
    w = rng.uniform(size=(num_w, max_pts)) < 0.7
    return [torch.tensor(np.ascontiguousarray(v), dtype=torch.float32, device=cuda)
            for v in (ya, yb, w, nx2, ny2)]


def assert_refit_kernel_matches_plain(args, num_pts):
    """The kernel against its plain twin on the same float32 inputs: one
    counted launch, ``ok`` equal, and ``a`` at the rtol and atol that hold
    the twin to the JAX package's QR (the same QR; the order of each sum
    differs); NaN poured into the rows at or past ``num_pts``, with weight 1
    there, changes no bit."""
    before = lstsq.KERNEL.launches
    a, ok = lstsq.weighted_lstsq8(*args, num_pts)
    ref_a, ref_ok = lstsq.weighted_lstsq8_plain(*args, num_pts)
    torch.cuda.synchronize()
    assert lstsq.KERNEL.launches == before + 1
    assert torch.equal(ok, ref_ok)
    torch.testing.assert_close(a[ok], ref_a[ok], rtol=1e-4, atol=1e-5)
    n = int(num_pts)
    poured = [v.clone() for v in args]
    for v in poured[:2] + poured[3:]:
        v[n:] = float("nan")
    poured[2][:, n:] = 1.0
    got = lstsq.weighted_lstsq8(*poured, num_pts)
    assert torch.equal(got[0], a) and torch.equal(got[1], ok)
    return a, ok


# A cluster of 8 blocks of 1024 threads takes 8192 points a sweep.
@pytest.mark.parametrize("num_w", [1, 3])
@pytest.mark.parametrize("num_pts", [0, 4, 8191, 8192 + 5, 9000, 32768])
def test_refit_kernel_matches_plain(cuda, num_w, num_pts):
    args = refit_inputs(cuda, num_w)
    a, ok = assert_refit_kernel_matches_plain(
        args, torch.tensor(num_pts, dtype=torch.int32, device=cuda))
    if num_pts > 1000:
        assert bool(ok.all())
    if num_pts == 0:
        assert not ok.any()


def test_refit_kernel_replays_in_a_graph(cuda):
    """Captured, the refit is one kernel node and nothing else; two replays
    give the eager call's bits (no atomics: every sum is taken in a fixed
    order)."""
    args = refit_inputs(cuda, 3)
    num_pts = torch.tensor(9000, dtype=torch.int32, device=cuda)
    eager = lstsq.weighted_lstsq8(*args, num_pts)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lstsq.weighted_lstsq8(*args, num_pts)
        nodes = trace.capture_nodes()
    assert nodes == {"kernel": 1}, nodes
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


def test_refit_kernel_in_the_homography_programs(cuda):
    """A register flow's ``find_homography`` calls the refit kernel 4 times
    (its four LO refits) and ``improve_homography`` none (IRLS keeps the
    plain QR), eager, capturing and replayed, with the eager run's bits.
    RANSAC's program holds fewer than 700 kernel nodes (686 on an H100;
    about 2,540 with the plain QR, some 460 a refit)."""
    from cudasift_tpu_torch.ops import homography

    progs = (homography._find_homography_jit, homography._improve_homography_jit)
    for p in progs:
        p.clear_cache()
    da, db, h_true = matched_flow(cuda)
    m = ct.match_sift_data(da, db)
    gen = torch.Generator(device=cuda)

    def call():
        gen.manual_seed(3)
        before = lstsq.KERNEL.launches
        h1, nm = ct.find_homography(m, gen, num_loops=2048, min_score=0.0, max_ambiguity=0.9,
                                    thresh=5.0)
        torch.cuda.synchronize()
        mid = lstsq.KERNEL.launches
        out = (h1, nm) + ct.improve_homography(m, h1, 5, 0.0, 0.9, 3.0)
        torch.cuda.synchronize()
        return out, (mid - before, lstsq.KERNEL.launches - mid)

    with jit.disable_graphs():
        eager, launches = call()
    assert launches == (4, 0)
    for what in ("first", "replay", "replay again"):
        out, launches = call()
        assert launches == (4, 0), what
        assert all(torch.equal(a, b) for a, b in zip(out, eager)), what
    assert synth.corner_error(eager[2].cpu().numpy(), h_true, 240, 320) < 1.0
    nodes = next(iter(progs[0].programs.values())).nodes["kernel"]
    assert nodes < 700, nodes


def test_sharded_matcher_on_a_repeated_device_mesh(cuda):
    """Four shards on one card: the indices, best and second equal
    single-device K4's bit for bit (the same 3xTF32 scores, selected), the
    ambiguity within 1e-6 relative; K4 launched once a shard."""
    from cudasift_tpu_torch import parallel

    mesh = parallel.Mesh((cuda,) * 4)
    g = torch.Generator(device=cuda).manual_seed(56)
    d1 = torch.nn.functional.normalize(torch.randn(1500, 128, device=cuda, generator=g), dim=1)
    d2 = torch.nn.functional.normalize(torch.randn(5000, 128, device=cuda, generator=g), dim=1)
    for n1, n2 in ((1500, 5000), (1400, 4321), (1500, 700)):
        n1_t = torch.tensor(n1, dtype=torch.int32, device=cuda)
        n2_t = torch.tensor(n2, dtype=torch.int32, device=cuda)
        before = match.KERNEL.launches
        score, amb, index = parallel.match_descriptors_sharded(d1, d2, n1_t, n2_t, mesh)
        assert match.KERNEL.launches == before + 4
        merged = parallel.sharding._match_top2_sharded(d1, d2, n1_t, n2_t, mesh, 512)
        best, second, ref_index = match.match_top2(d1, d2, n1_t, n2_t)
        assert torch.equal(index, ref_index) and torch.equal(score, best), (n1, n2)
        assert torch.equal(merged[0], best) and torch.equal(merged[1], second), (n1, n2)
        torch.testing.assert_close(amb, second / (best + 1e-6), rtol=1e-6, atol=0)


def test_sharded_extraction_on_a_repeated_device_mesh(cuda):
    from cudasift_tpu_torch import parallel

    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    frames = torch.stack([torch.as_tensor(make_test_image(192, 256, seed=s), device=cuda)
                          for s in (82, 83, 84, 85)])
    with jit.disable_graphs():
        singles = [ct.extract_sift(f, params) for f in frames]
    mesh = parallel.Mesh((cuda,) * 4)
    for fn in (parallel.extract_sift_throughput_sharded, parallel.extract_sift_batched):
        for _ in range(2):                               # captured, then replayed
            got = fn(frames, params, mesh)
        torch.cuda.synchronize()
        for i, single in enumerate(singles):
            for name in ct.SiftData.__dataclass_fields__:
                assert torch.equal(getattr(got, name)[i], getattr(single, name)), (fn, i, name)
    assert len(parallel.make_mesh().devices) == torch.cuda.device_count()
    with pytest.raises(ValueError, match="not divisible"):
        parallel.extract_sift_throughput_sharded(frames[:3], params, mesh)


def test_dryrun_on_the_card(cuda):
    from cudasift_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4)
    assert len(out["num_pts"]) == 4 and all(d.startswith("cuda") for d in out["devices"])


# ---- ScaleUp ------------------------------------------------------------------

# One pixel, one row or column, odd widths (8-byte stores), a small frame and
# the 1280x960 frame of the upscale cell.
@pytest.mark.parametrize("h,w", [(1, 1), (1, 6), (6, 1), (5, 7), (7, 9), (6, 8), (192, 256),
                                 (960, 1280)])
def test_scale_up_kernel_equals_plain(cuda, h, w):
    img = torch.as_tensor(make_test_image(max(h, 8), max(w, 8), seed=h + w)[:h, :w].copy(),
                          device=cuda)
    before = scale_up.KERNEL.launches
    got = scale_up.scale_up(img)
    torch.cuda.synchronize()
    assert scale_up.KERNEL.launches == before + 1
    assert got.shape == (2 * h, 2 * w) and torch.equal(got, convolve.scale_up(img))
    # The same pixels one float past an allocation's start (the input off
    # 8 bytes: scalar loads, 8-byte stores).
    store = torch.empty(h * w + 1, device=cuda)
    shifted = store[1:].view(h, w)
    shifted.copy_(img)
    assert torch.equal(scale_up.scale_up(shifted), got)


def test_scale_up_kernel_in_the_extraction_program(cuda):
    """``extract_sift`` with ``scale_up`` launches the kernel once a call,
    eager, capturing and replayed, each equal to the eager run; its program
    holds four kernel nodes more than the same program without upscale (the
    kernel and the merge's three halvings); traced, ``extract.upscale`` is a stage of its
    own inside ``extract.pyramid``."""
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048, scale_up=True)
    img = torch.as_tensor(make_test_image(192, 256, seed=80), device=cuda)
    pipeline._extract_sift_jit.clear_cache()

    def call(p=params):
        before = scale_up.KERNEL.launches
        out = ct.extract_sift(img, p)
        torch.cuda.synchronize()
        return out, scale_up.KERNEL.launches - before

    try:
        with jit.disable_graphs():
            eager, launches = call()
        assert launches == 1 and int(eager.num_pts) > 30
        for what in ("capturing", "replay", "replay again"):
            out, launches = call()
            assert launches == 1, what
            assert_sift_equal(out, eager, what)
        (program,) = pipeline._extract_sift_jit.programs.values()
        up_nodes = program.nodes["kernel"]
        pipeline._extract_sift_jit.clear_cache()
        assert call(ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048))[1] == 0
        (plain,) = pipeline._extract_sift_jit.programs.values()
        # ScaleUp and the three halvings of the merged positions and scales.
        assert up_nodes == plain.nodes["kernel"] + 1 + 3
        pipeline._extract_sift_jit.clear_cache()
        trace.enable()
        for _ in range(3):
            assert call()[1] == 1
        stages = trace.snapshot()["last_stages"]["_extract_sift_jit"]
    finally:
        trace.disable()
        trace.clear()
        pipeline._extract_sift_jit.clear_cache()
    names = [s["name"] for s in stages]
    up = stages[names.index("extract.upscale")]
    assert stages[up["parent"]]["name"] == "extract.pyramid"


def test_a_default_program_keeps_its_nodes_and_stages(cuda):
    """At the benchmark's 1920x1080 settings, without ``scale_up``: 361
    kernel nodes, and no ``extract.upscale`` stage when traced."""
    params = ct.SiftParams(num_octaves=5, init_blur=1.0, thresh=3.0, max_pts=32768)
    img = torch.as_tensor(synth.make_leaves_image(1080, 1920, 0), device=cuda)
    pipeline._extract_sift_jit.clear_cache()
    before = scale_up.KERNEL.launches
    try:
        ct.extract_sift(img, params)
        (program,) = pipeline._extract_sift_jit.programs.values()
        assert program.nodes["kernel"] == 361
        trace.enable()
        for _ in range(3):
            ct.extract_sift(img, params)
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.clear()
        pipeline._extract_sift_jit.clear_cache()
    assert scale_up.KERNEL.launches == before
    assert snap["stages"]["extract.pyramid"]["count"] >= 1
    assert "extract.upscale" not in snap["stages"]
    assert "extract.upscale" not in {s["name"] for s in snap["last_stages"]["_extract_sift_jit"]}


# ---- utils.trace on the card ------------------------------------------------

def test_trace_stages_cover_the_replay(cuda):
    """A replayed 1920x1080 extraction with tracing on: every stage takes
    time, and pyramid + octaves + merge come within 3% of the same call's
    replay (its jit.call events from the end of the copy-in to the start of
    the clones), so no part of the graph is outside a stage. The traced
    program holds the off program's nodes and at most 40 stamp kernels."""
    params = ct.SiftParams(num_octaves=5, thresh=3.0, max_pts=32768)
    img = torch.as_tensor(synth.make_leaves_image(1080, 1920, 0), device=cuda)
    pipeline._extract_sift_jit.clear_cache()
    ct.extract_sift(img, params)
    trace.enable()
    try:
        for _ in range(4):
            assert int(ct.extract_sift(img, params).num_pts) > 1000
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.clear()
        pipeline._extract_sift_jit.clear_cache()
    nodes = {p["traced"]: p["nodes"] for p in snap["programs"]
             if p["function"] == "_extract_sift_jit"}
    assert nodes[True]["kernel"] == nodes[False]["kernel"] > 300
    assert "stamp" not in nodes[False] and 0 < nodes[True]["stamp"] <= 40
    assert {k: n for k, n in nodes[True].items() if k != "stamp"} == nodes[False]
    assert snap["launches"]["stamp"] > 0
    stages = snap["last_stages"]["_extract_sift_jit"]
    assert [s["name"] for s in stages if s["parent"] == -1] == (
        ["extract.pyramid"] + ["extract.octave"] * 5 + ["extract.merge"])
    assert len(stages) == 2 + 5 * 5 and all(s["end_ms"] > s["start_ms"] for s in stages)
    top = sum(s["end_ms"] - s["start_ms"] for s in stages if s["parent"] == -1)
    call = [c for c in snap["calls"] if c["function"] == "_extract_sift_jit"][-1]
    assert abs(top - call["replay_ms"]) <= 0.03 * call["replay_ms"], (top, call)
    assert len(snap["calls"]) == 3 and snap["calls"][-1]["gap_ms"] > 0


def test_trace_counts_the_off_program_as_captured(cuda):
    """The nodes of a program captured with tracing off, counted during its
    capture, equal those of the same body captured by hand and read from the
    kept graph: no event-record node, the body's kernels."""
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    img = torch.as_tensor(make_test_image(192, 256, seed=79), device=cuda)
    pipeline._extract_sift_jit.clear_cache()
    ct.extract_sift(img, params)
    (program,) = pipeline._extract_sift_jit.programs.values()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    static = img.clone()
    with torch.cuda.graph(graph):
        pipeline._extract(static, params)
    by_hand = trace.graph_nodes(graph.raw_cuda_graph())
    assert program.nodes == by_hand and program.nodes["kernel"] > 30
    assert "event_record" not in program.nodes
    pipeline._extract_sift_jit.clear_cache()


def test_host_span_holds_the_profilers_launch_record(cuda):
    """Host spans and the profiler's timeline share a clock: a span around
    a kernel's launch contains the runtime call that launched it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(10)
    torch.cuda.synchronize()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with trace.span("sleep"):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        (span,) = [s for s in trace.snapshot()["spans"] if s["name"] == "sleep"]
    finally:
        trace.disable()
        trace.clear()
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events() if "LaunchKernel" in e.name()]
    assert launches
    assert any(span["start_ns"] <= a and b <= span["end_ns"] for a, b in launches), (
        span, launches)
