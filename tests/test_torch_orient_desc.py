"""Plain version of the fused orientation+descriptor kernel (K3) against the
JAX package's Pallas kernel in interpret mode, in both samplers, with
keypoints in both scale buckets and near every image border."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudasift_tpu.ops.pallas.orient_desc import orient_and_describe_pallas

from cudasift_tpu_torch.ops import descriptor
from cudasift_tpu_torch.ops.cuda import orient_desc
from cudasift_tpu_torch.utils.synth import make_test_image


def keypoints(h, w, rng):
    """16 interior keypoints in both scale buckets, then 16 at 1.3-6.7 px
    from each edge; two dead slots."""
    x = list(rng.uniform(30, w - 30, 16))
    y = list(rng.uniform(30, h - 30, 16))
    s = list(rng.uniform(0.95, 1.65, 12)) + list(rng.uniform(1.8, 2.4, 4))
    for d in (1.3, 2.8, 4.1, 6.7):
        for px, py, ps in ((d, 40.2, 1.1), (w - 1 - d, 50.5, 1.9),
                           (80.3, d, 1.2), (30.7, h - 1 - d, 2.2)):
            x.append(px)
            y.append(py)
            s.append(ps)
    live = np.ones(len(x), bool)
    live[[3, 20]] = False
    f32 = np.float32
    return np.asarray(x, f32), np.asarray(y, f32), np.asarray(s, f32), live


def angle_err(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 360.0 - d)


@pytest.mark.parametrize("mode", ["shift", "exact"])
def test_orient_describe_plain_matches_pallas(mode):
    rng = np.random.default_rng(21)
    img = make_test_image(96, 160, seed=21)
    x, y, s, live = keypoints(*img.shape, rng)
    jd1, jd2, jo1, jo2, jh2 = (np.asarray(a) for a in orient_and_describe_pallas(
        jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), jnp.asarray(s),
        interpret=True, mode=mode, live=jnp.asarray(live)))
    tx, ty, ts = (torch.as_tensor(a) for a in (x, y, s))
    launches = orient_desc.KERNEL.launches
    d1, d2, o1, o2, h2 = orient_desc.orient_and_describe(
        torch.as_tensor(img), tx, ty, ts, torch.as_tensor(live), mode)
    assert orient_desc.KERNEL.launches == launches

    # Orientations: the TPU kernel selects its grid in bf16 hi+lo halves.
    err = angle_err(o1.numpy(), jo1)[live]
    assert np.median(err) < 0.2 and (err < 2.0).mean() >= 0.9, err
    assert (h2.numpy() == jh2)[live].mean() >= 0.9

    # Descriptors at the TPU kernel's own orientations: the bf16 envelope
    # (the port samples in float32).
    ref = descriptor.extract_descriptors(torch.as_tensor(img), tx, ty, ts,
                                         torch.tensor(jo1), mode).numpy()
    row = np.abs(ref - jd1).max(axis=1)[live]
    assert np.median(row) < 4e-3 and row.max() < 2e-2, row
    both = h2.numpy() & jh2
    if both.any():
        ref2 = descriptor.extract_descriptors(torch.as_tensor(img), tx, ty, ts,
                                              torch.tensor(jo2), mode).numpy()
        assert np.abs(ref2 - jd2).max(axis=1)[both].max() < 2e-2
    # The port's own descriptors where its orientation agrees.
    same = live & (angle_err(o1.numpy(), jo1) < 0.05)
    assert same.sum() >= 0.8 * live.sum()
    row = np.abs(d1.numpy() - jd1).max(axis=1)[same]
    assert np.median(row) < 4e-3 and row.max() < 2e-2, row

    # Unit norms on live slots; dead slots are zero, as in the TPU kernel.
    np.testing.assert_allclose(np.linalg.norm(d1.numpy()[live], axis=1), 1.0, atol=1e-5)
    for a in (d1, d2, o1, o2):
        assert not a.numpy()[~live].any()
    assert not h2.numpy()[~live].any()
    assert not d2.numpy()[~h2.numpy()].any()
    assert not jd1[~live].any()


def test_live_mask_gates_slots():
    rng = np.random.default_rng(22)
    img = torch.as_tensor(make_test_image(64, 96, seed=22))
    n = 12
    x = torch.as_tensor(rng.uniform(20, 76, n).astype(np.float32))
    y = torch.as_tensor(rng.uniform(20, 44, n).astype(np.float32))
    s = torch.full((n,), 1.2)
    full = orient_desc.orient_and_describe(img, x, y, s, torch.ones(n, dtype=torch.bool))
    live = torch.arange(n) % 3 != 0
    gated = orient_desc.orient_and_describe(img, x, y, s, live)
    for a, b in zip(full[:4], gated[:4]):
        mask = live if a.dim() == 1 else live[:, None]
        assert torch.equal(torch.where(mask, a, 0.0), b)
    assert torch.equal(full[4] & live, gated[4])
