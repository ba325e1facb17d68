"""The split orientation/descriptor path: plain versions of the
orientation-histogram kernel (K6) and the descriptor kernel (K7) against the
JAX package's Pallas kernels in interpret mode and its XLA versions, their
count gate, and the split pipeline against the JAX package on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cudasift_tpu as cs
from cudasift_tpu.ops.descriptor import extract_descriptors as jax_descriptors
from cudasift_tpu.ops.orient import orientation_histograms as jax_histograms
from cudasift_tpu.ops.pallas.descriptor import extract_descriptors_pallas
from cudasift_tpu.ops.pallas.orient import orientation_histograms_pallas

import cudasift_tpu_torch as ct
from cudasift_tpu_torch.ops import orient as torient
from cudasift_tpu_torch.ops.cuda import descriptor, orient
from cudasift_tpu_torch.utils import synth
from cudasift_tpu_torch.utils.synth import make_test_image

H, W = 96, 160


def keypoints(rng, margin):
    """10 interior keypoints, then 6 whose floor(x) or floor(y) lies below
    ``margin`` (the kernel's patch margin), so the patch origin clamps at 0
    (one of them at a small negative position); scales in both of the fused
    kernel's buckets."""
    x = list(rng.uniform(margin + 2, W - margin - 3, 10))
    y = list(rng.uniform(margin + 2, H - margin - 3, 10))
    x += [0.4, 3.7, margin - 1.3, 60.2, 110.6, -0.3]
    y += [40.1, 2.2, 50.8, 1.6, margin - 2.4, 30.7]
    s = list(rng.uniform(0.95, 1.87, 16))
    f32 = np.float32
    return np.asarray(x, f32), np.asarray(y, f32), np.asarray(s, f32)


def tt(*arrs):
    return [torch.as_tensor(a) for a in arrs]


def angle_err(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 360.0 - d)


def assert_histograms_close(ours, ref):
    """The bars of the JAX package's own kernel test (tests/test_pallas.py):
    bfloat16 selection flips single samples between adjacent bins."""
    for i in range(ours.shape[0]):
        c = np.corrcoef(ours[i], ref[i])[0, 1]
        assert c > 0.995, (i, c)
    p1, _, _ = torient.histogram_peaks(torch.as_tensor(ours))
    p2, _, _ = torient.histogram_peaks(torch.tensor(ref))
    d = angle_err(p1.numpy(), p2.numpy())
    assert np.median(d) < 0.2 and (d < 2.0).mean() >= 0.9, d


def test_orientation_histograms_plain_matches_pallas_and_xla():
    rng = np.random.default_rng(31)
    img = make_test_image(H, W, seed=31)
    x, y, s = keypoints(rng, 7)
    launches = orient.KERNEL.launches
    ours = orient.orientation_histograms(*tt(img, x, y, s), 16).numpy()
    assert orient.KERNEL.launches == launches        # CPU tensors: plain version
    ref = np.asarray(orientation_histograms_pallas(
        jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), interpret=True))
    assert ours.shape == (16, 32) and (ours.sum(axis=1) > 0).all()
    assert_histograms_close(ours, ref)
    # The XLA version clamps its own patch differently at the border; on
    # interior keypoints it samples the same points (atan2 in place of the
    # polynomial).
    xla = np.asarray(jax_histograms(jnp.asarray(img), jnp.asarray(x[:10]),
                                    jnp.asarray(y[:10]), jnp.asarray(s[:10])))
    assert_histograms_close(ours[:10], xla)


def test_descriptors_plain_matches_pallas_and_xla():
    rng = np.random.default_rng(32)
    img = make_test_image(H, W, seed=32)
    x, y, s = keypoints(rng, 22)
    ori = rng.uniform(0, 360, 16).astype(np.float32)
    launches = descriptor.KERNEL.launches
    ours = descriptor.extract_descriptors(*tt(img, x, y, s, ori), 16).numpy()
    assert descriptor.KERNEL.launches == launches
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, atol=1e-4)
    ref = np.asarray(extract_descriptors_pallas(
        jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), jnp.asarray(s),
        jnp.asarray(ori), interpret=True))
    # The TPU kernel samples in bfloat16 on the MXU; the port in float32.
    row = np.abs(ours - ref).max(axis=1)
    assert np.median(row) < 4e-3 and row.max() < 2e-2, row
    # Both float32 on interior keypoints.
    xla = np.asarray(jax_descriptors(jnp.asarray(img), jnp.asarray(x[:10]), jnp.asarray(y[:10]),
                                     jnp.asarray(s[:10]), jnp.asarray(ori[:10])))
    np.testing.assert_allclose(ours[:10], xla, atol=2e-5)


def test_count_gate_zeroes_later_slots():
    rng = np.random.default_rng(33)
    img = make_test_image(H, W, seed=33)
    x, y, s = keypoints(rng, 22)
    ori = rng.uniform(0, 360, 16).astype(np.float32)
    args = tt(img, x, y, s)
    full_h = orient.orientation_histograms(*args, 16)
    full_d = descriptor.extract_descriptors(*args, torch.as_tensor(ori), 16)
    for count in (0, 5, torch.tensor(11, dtype=torch.int32)):
        c = int(count)
        hist = orient.orientation_histograms(*args, count)
        desc = descriptor.extract_descriptors(*args, torch.as_tensor(ori), count)
        assert torch.equal(hist[:c], full_h[:c]) and not hist[c:].any()
        assert torch.equal(desc[:c], full_d[:c]) and not desc[c:].any()


def keyset(d, n):
    return {(round(float(a), 2), round(float(b), 2), round(float(c), 2))
            for a, b, c in zip(np.asarray(d.xpos)[:n], np.asarray(d.ypos)[:n],
                               np.asarray(d.scale)[:n])}


@pytest.mark.parametrize("num_octaves,use_pallas_compact", [(2, True), (3, False)])
def test_split_pipeline_matches_jax(num_octaves, use_pallas_compact):
    """The split path against the JAX package's CPU path, which has the
    same orient -> compact -> describe structure with the XLA versions;
    bars as the fused path's test (tests/test_torch_pipeline.py)."""
    img = make_test_image(192, 256, seed=41)
    kw = dict(num_octaves=num_octaves, thresh=2.0, max_pts=2048)
    jd = cs.extract_sift(img, cs.SiftParams(**kw))
    td = ct.extract_sift(img, ct.SiftParams(use_fused=False,
                                            use_pallas_compact=use_pallas_compact, **kw),
                         device="cpu")
    nj, nt = int(jd.num_pts), int(td.num_pts)
    assert nt > 30 and abs(nt - nj) <= max(2, nj // 50)
    kj, kt = keyset(jd, nj), keyset(td, nt)
    assert len(kj & kt) / max(len(kj), len(kt)) >= 0.97
    assert int(td.overflow) == int(jd.overflow) == 0

    def oriented(d, n):
        f = [np.asarray(getattr(d, k))[:n] for k in ("xpos", "ypos", "scale", "orientation")]
        keys = zip(*(np.round(v, 2) for v in f[:3]), np.round(f[3], 0))
        return dict(zip(keys, np.asarray(d.data)[:n]))

    oj, ot = oriented(jd, nj), oriented(td, nt)
    shared = oj.keys() & ot.keys()
    assert len(shared) >= 0.9 * max(len(oj), len(ot))
    cos = [float(oj[k] @ ot[k]) for k in shared]
    assert np.median(cos) >= 0.999, np.median(cos)
    assert not td.data[nt:].any() and not td.xpos[nt:].any()
    np.testing.assert_allclose(td.data[:nt].norm(dim=1).numpy(), 1.0, atol=1e-5)

    # The compaction kernel's plain version gives the same point set, and
    # the fused path with exact descriptors nearly the same one.
    other = ct.extract_sift(img, ct.SiftParams(use_fused=False,
                                               use_pallas_compact=not use_pallas_compact, **kw),
                            device="cpu")
    for name in ct.SiftData.__dataclass_fields__:
        assert torch.equal(getattr(other, name), getattr(td, name)), name
    fused = ct.extract_sift(img, ct.SiftParams(grad_mode="exact", **kw), device="cpu")
    kf = keyset(fused, int(fused.num_pts))
    assert len(kf & kt) / max(len(kf), len(kt)) >= 0.98


def test_split_flow_on_leaves_pair_recovers_homography():
    """The dead-leaves pair (``synth.make_leaves_image``) gives the ratio
    test margin where the blocks pair passes about 8 matches; the split
    flow recovers the known warp from it."""
    h, w = 192, 320
    img_a = synth.make_leaves_image(h, w, seed=0)
    hm = synth.known_homography(h, w)
    img_b = synth.warp_image(img_a, hm)
    params = ct.SiftParams(num_octaves=3, thresh=3.0, max_pts=2048, use_fused=False,
                           use_pallas_compact=True)
    da = ct.extract_sift(img_a, params, device="cpu")
    db = ct.extract_sift(img_b, params, device="cpu")
    assert int(da.overflow) == int(db.overflow) == 0
    m = ct.match_sift_data(da, db)
    n = int(da.num_pts)
    assert int(((m.ambiguity[:n] < 0.8) & (m.score[:n] > 0)).sum()) >= 24
    gen = torch.Generator().manual_seed(0)
    h1, nm = ct.find_homography(m, gen, num_loops=1024, min_score=0.0,
                                max_ambiguity=0.80, thresh=5.0)
    h2, nfit, _ = ct.improve_homography(m, h1, 5, 0.0, 0.80, 3.0)
    assert int(nfit) > 50
    assert synth.corner_error(h2.numpy(), hm, h, w) < 1.0
