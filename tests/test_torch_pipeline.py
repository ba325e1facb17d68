"""The port's main path as a whole: extraction against the JAX package on
the CPU, determinism, overflow accounting, and the two-frame demo flow on a
synthetic pair with a known homography."""

import numpy as np
import pytest
import torch

import cudasift_tpu as cs

import cudasift_tpu_torch as ct
from cudasift_tpu_torch.utils import synth

H_IMG, W_IMG = 192, 256


def keyset(x, y, s, n):
    return {(round(float(a), 2), round(float(b), 2), round(float(c), 2))
            for a, b, c in zip(np.asarray(x)[:n], np.asarray(y)[:n], np.asarray(s)[:n])}


@pytest.mark.parametrize("num_octaves,scale_up", [(2, False), (3, False), (2, True)])
def test_extract_matches_jax(num_octaves, scale_up):
    img = synth.make_test_image(H_IMG, W_IMG, seed=41)
    if scale_up:
        img = img[:96, :128].copy()
    kw = dict(num_octaves=num_octaves, thresh=2.0, max_pts=2048, scale_up=scale_up)
    jd = cs.extract_sift(img, cs.SiftParams(**kw))
    # The JAX package's CPU path samples descriptors exactly.
    td = ct.extract_sift(img, ct.SiftParams(grad_mode="exact", **kw), device="cpu")
    nj, nt = int(jd.num_pts), int(td.num_pts)
    assert nt > 30 and abs(nt - nj) <= max(2, nj // 50)
    kj = keyset(jd.xpos, jd.ypos, jd.scale, nj)
    kt = keyset(td.xpos, td.ypos, td.scale, nt)
    assert len(kj & kt) / max(len(kj), len(kt)) >= 0.97
    assert int(td.overflow) == int(jd.overflow) == 0

    # Descriptor cosine on the oriented keypoints both extract.
    def oriented(d, n):
        f = [np.asarray(getattr(d, k))[:n] for k in ("xpos", "ypos", "scale", "orientation")]
        keys = zip(*(np.round(v, 2) for v in f[:3]), np.round(f[3], 0))
        return dict(zip(keys, np.asarray(d.data)[:n]))

    oj, ot = oriented(jd, nj), oriented(td, nt)
    shared = oj.keys() & ot.keys()
    assert len(shared) >= 0.9 * max(len(oj), len(ot))
    cos = [float(oj[k] @ ot[k]) for k in shared]
    assert np.median(cos) >= 0.999, np.median(cos)
    # Slots past num_pts are zero; subsampling marks the octave.
    assert not td.data[nt:].any() and not td.xpos[nt:].any()
    assert set(np.unique(td.subsampling.numpy()[:nt])) <= {1.0, 2.0, 4.0}


def test_extract_deterministic_and_finite():
    img = synth.make_test_image(H_IMG, W_IMG, seed=42)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=1024)
    a = ct.extract_sift(img, params, device="cpu")
    b = ct.extract_sift(torch.as_tensor(img), params)
    for name in ct.SiftData.__dataclass_fields__:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    n = int(a.num_pts)
    assert n > 30 and int(a.overflow) == 0
    assert bool(torch.isfinite(a.data[:n]).all())
    np.testing.assert_allclose(a.data[:n].norm(dim=1).numpy(), 1.0, atol=1e-5)
    batch = ct.extract_sift_throughput(np.stack([img, img[::-1].copy()]), params, device="cpu")
    assert batch.num_pts.shape == (2,) and int(batch.num_pts[0]) == n
    assert torch.equal(batch.data[0], a.data)


def test_overflow_and_max_pts_clamp_match_jax():
    img = np.random.default_rng(3).uniform(0, 255, (128, 160)).astype(np.float32)
    kw = dict(num_octaves=1, thresh=0.5, max_pts=128, min_candidates=128)
    jd = cs.extract_sift(img, cs.SiftParams(**kw))
    td = ct.extract_sift(img, ct.SiftParams(**kw), device="cpu")
    assert int(td.num_pts) == int(jd.num_pts) == 128        # saturated
    # ... and says so. The count includes second-orientation duplicates,
    # whose peaks the fused kernel's orientation grid may place on the other
    # side of the 0.8 ratio for a rare keypoint.
    assert int(jd.overflow) > 0
    assert abs(int(td.overflow) - int(jd.overflow)) <= max(2, int(jd.overflow) // 100)
    # Global clamp only: per-octave slots suffice, max_pts does not.
    img = synth.make_test_image(128, 160, seed=43)
    kw = dict(num_octaves=2, thresh=2.0, max_pts=64)
    big = ct.extract_sift(img, ct.SiftParams(**dict(kw, max_pts=4096)), device="cpu")
    small = ct.extract_sift(img, ct.SiftParams(**kw), device="cpu")
    assert int(big.overflow) == 0 and int(big.num_pts) > 64
    assert int(small.num_pts) == 64
    assert int(small.overflow) == int(big.num_pts) - 64
    assert torch.equal(small.xpos, big.xpos[:64])


def test_unported_settings_raise():
    """Every sampler and path is ported: the fast settings, the split path
    and the compaction kernel run; only an unknown sampler and malformed
    frames raise."""
    img = np.zeros((32, 32), np.float32)
    for kw in ({"grad_mode": "fast"}, {"fast_gradients": True},
               {"grad_mode": "fast", "use_fused": False},
               {"use_fused": False}, {"use_pallas_compact": True}):
        d = ct.extract_sift(img, ct.SiftParams(num_octaves=2, **kw), device="cpu")
        assert int(d.num_pts) == 0
    with pytest.raises(ValueError):
        ct.extract_sift(img, ct.SiftParams(grad_mode="bogus"), device="cpu")
    with pytest.raises(ValueError):
        ct.extract_sift(np.zeros((2, 32, 32), np.float32), device="cpu")
    with pytest.raises(ValueError):
        ct.extract_sift_throughput(img, device="cpu")
    flat = ct.extract_sift(np.full((64, 64), 7.0, np.float32), ct.SiftParams(num_octaves=2),
                           device="cpu")
    assert int(flat.num_pts) == 0 and bool(torch.isfinite(flat.data).all())


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Array-likes go to the card by default; with no card that raises,
    naming device="cpu", and nothing runs on the CPU. A tensor stays where
    the caller put it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = synth.make_test_image(64, 96, seed=44)
    params = ct.SiftParams(num_octaves=2)
    for call in (lambda: ct.extract_sift(img, params),
                 lambda: ct.extract_sift_throughput(img[None], params),
                 lambda: ct.extract_sift(torch.as_tensor(img), params, device="cuda"),
                 lambda: ct.init_sift_data(16)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    on_cpu = ct.extract_sift(torch.as_tensor(img), params)
    assert on_cpu.device.type == "cpu"
    asked = ct.extract_sift(img, params, device="cpu")
    assert torch.equal(asked.data, on_cpu.data)
    assert ct.init_sift_data(16, device="cpu").device.type == "cpu"


def test_pair_flow_recovers_known_homography():
    img_a = synth.make_test_image(H_IMG, W_IMG, seed=0)
    hm = synth.known_homography(H_IMG, W_IMG)
    img_b = synth.warp_image(img_a, hm)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    da = ct.extract_sift(img_a, params, device="cpu")
    db = ct.extract_sift(img_b, params, device="cpu")
    m = ct.match_sift_data(da, db)
    n = int(da.num_pts)
    assert (m.match[:n] >= 0).all() and (m.match[n:] == -1).all()
    assert int((m.ambiguity[:n] < 0.8).sum()) >= 8
    gen = torch.Generator().manual_seed(0)
    h1, nm = ct.find_homography(m, gen, num_loops=2048, min_score=0.0,
                                max_ambiguity=0.80, thresh=5.0)
    h2, nfit, err = ct.improve_homography(m, h1, 5, 0.0, 0.80, 3.0)
    assert int(nm) > 50 and int(nfit) > 50
    assert synth.corner_error(h2.numpy(), hm, H_IMG, W_IMG) < 1.0
    # An empty set through match and RANSAC: identity, no matches.
    empty = ct.init_sift_data(256, device="cpu")
    e = ct.match_sift_data(empty, db)
    h, nm = ct.find_homography(e, gen, num_loops=64)
    np.testing.assert_array_equal(h.numpy(), np.eye(3, dtype=np.float32))
    assert int(nm) == 0 and not e.score.any()


def test_warp_moves_points_by_the_homography():
    img = synth.make_test_image(H_IMG, W_IMG, seed=1)
    hm = synth.known_homography(H_IMG, W_IMG)
    warped = synth.warp_image(img, hm)
    # A pixel of img at p lands at hm p in the warped frame.
    p = np.array([120.0, 90.0, 1.0])
    q = hm @ p
    q = q[:2] / q[2]
    qi = np.round(q).astype(int)
    src = np.linalg.inv(hm) @ np.array([qi[0], qi[1], 1.0])
    src = src[:2] / src[2]
    x0, y0 = int(np.floor(src[0])), int(np.floor(src[1]))
    fx, fy = src[0] - x0, src[1] - y0
    ref = ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
           + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))
    assert warped[qi[1], qi[0]] == pytest.approx(ref, rel=1e-5)
    assert synth.corner_error(hm, hm, H_IMG, W_IMG) == 0.0
