"""K3's third sampler, ``"fast"`` (``grad_mode="fast"`` /
``fast_gradients=True``): its plain version against the JAX package's Pallas
kernel in interpret mode, its distance from ``"exact"``, the settings that
select it, and the fused pipeline with it against the JAX package's fused
branch."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

import cudasift_tpu.pipeline as jpl
from cudasift_tpu.config import SiftParams as JaxSiftParams
from cudasift_tpu.ops.pallas import dog as jdog
from cudasift_tpu.ops.pallas import orient_desc as jod
from cudasift_tpu.ops.pallas import refine as jrefine
from cudasift_tpu.ops.pallas.orient_desc import orient_and_describe_pallas

import cudasift_tpu_torch as ct
from cudasift_tpu_torch.ops import descriptor
from cudasift_tpu_torch.ops.cuda import orient_desc
from cudasift_tpu_torch.utils.synth import make_test_image

import golden
from test_torch_orient_desc import angle_err, keypoints


def test_fast_plain_matches_pallas():
    """Same keypoints as the shift/exact test (both scale buckets, every
    border, two dead slots) and the same bars: the TPU kernel rounds its
    difference fields and tents to bf16, the port stays in float32."""
    rng = np.random.default_rng(21)
    img = make_test_image(96, 160, seed=21)
    x, y, s, live = keypoints(*img.shape, rng)
    jd1, jd2, jo1, jo2, jh2 = (np.asarray(a) for a in orient_and_describe_pallas(
        jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), jnp.asarray(s),
        interpret=True, mode="fast", live=jnp.asarray(live)))
    timg = torch.as_tensor(img)
    tx, ty, ts = (torch.as_tensor(a) for a in (x, y, s))
    launches = orient_desc.KERNEL.launches
    d1, d2, o1, o2, h2 = orient_desc.orient_and_describe(timg, tx, ty, ts,
                                                         torch.as_tensor(live), "fast")
    assert orient_desc.KERNEL.launches == launches

    err = angle_err(o1.numpy(), jo1)[live]
    assert np.median(err) < 0.2 and (err < 2.0).mean() >= 0.9, err
    assert (h2.numpy() == jh2)[live].mean() >= 0.9

    # Descriptors at the TPU kernel's own orientations: the bf16 envelope.
    ref = descriptor.extract_descriptors(timg, tx, ty, ts, torch.tensor(jo1), "fast").numpy()
    row = np.abs(ref - jd1).max(axis=1)[live]
    assert np.median(row) < 4e-3 and row.max() < 2e-2, row
    both = h2.numpy() & jh2
    assert both.any()
    ref2 = descriptor.extract_descriptors(timg, tx, ty, ts, torch.tensor(jo2), "fast").numpy()
    assert np.abs(ref2 - jd2).max(axis=1)[both].max() < 2e-2
    same = live & (angle_err(o1.numpy(), jo1) < 0.05)
    assert same.sum() >= 0.8 * live.sum()
    row = np.abs(d1.numpy() - jd1).max(axis=1)[same]
    assert np.median(row) < 4e-3 and row.max() < 2e-2, row

    np.testing.assert_allclose(np.linalg.norm(d1.numpy()[live], axis=1), 1.0, atol=1e-5)
    for a in (d1, d2, o1, o2):
        assert not a.numpy()[~live].any()
    assert not d2.numpy()[~h2.numpy()].any()


def test_fast_gradients_close_to_exact():
    """The JAX property (tests/test_pallas.py::test_fast_gradients_close_to_exact)
    on the port: orientations bit-identical to exact, descriptors within the
    O(h^2) curvature terms of the central differences."""
    rng = np.random.default_rng(42)
    img = (rng.standard_normal((96, 160)) * 30 + 120).astype(np.float32)
    img = golden.sep_conv_clamp(img, golden.gaussian_kernel(2, 1.0)).astype(np.float32)
    h, w = img.shape
    n = 16
    x = torch.as_tensor(rng.uniform(25, w - 25, n).astype(np.float32))
    y = torch.as_tensor(rng.uniform(25, h - 25, n).astype(np.float32))
    s = torch.as_tensor(rng.uniform(0.95, 1.85, n).astype(np.float32))
    live = torch.ones(n, dtype=torch.bool)
    exact = orient_desc.orient_and_describe(torch.as_tensor(img), x, y, s, live, "exact")
    fast = orient_desc.orient_and_describe(torch.as_tensor(img), x, y, s, live, "fast")
    assert torch.equal(exact[2], fast[2]) and torch.equal(exact[4], fast[4])
    de, df = exact[0].numpy(), fast[0].numpy()
    cos = (de * df).sum(axis=1)
    assert cos.min() > 0.97, cos
    assert np.abs(de - df).max() < 0.08


def test_fast_settings_select_the_fast_sampler():
    """``fast_gradients=True`` is ``grad_mode="fast"`` bit for bit and
    differs from the default sampler; the split path ignores the sampler
    (its descriptors are exact), as the JAX package's split path does."""
    img = make_test_image(96, 128, seed=61)
    kw = dict(num_octaves=2, thresh=2.0, max_pts=1024)

    def run(**extra):
        return ct.extract_sift(img, ct.SiftParams(**kw, **extra), device="cpu")

    fast, alias, shift = run(grad_mode="fast"), run(fast_gradients=True), run()
    n = int(fast.num_pts)
    assert n > 20
    for name in ct.SiftData.__dataclass_fields__:
        assert torch.equal(getattr(fast, name), getattr(alias, name)), name
    assert torch.equal(fast.xpos, shift.xpos) and not torch.equal(fast.data, shift.data)
    split_fast = run(use_fused=False, grad_mode="fast")
    split_shift = run(use_fused=False)
    for name in ct.SiftData.__dataclass_fields__:
        assert torch.equal(getattr(split_fast, name), getattr(split_shift, name)), name


def test_fast_pipeline_matches_jax_fused_branch(monkeypatch):
    """The port's fused pipeline with the fast sampler against the JAX
    package's fused branch driven on the CPU with interpret-mode kernels
    (the recipe of tests/test_pipeline.py::
    test_fused_pipeline_branch_interpret_matches_xla, test-side only), one
    octave of a 128x192 frame: key-set overlap >= 0.97 and the descriptors
    of shared oriented keypoints within the bf16 envelope."""
    monkeypatch.setattr(jpl, "_on_tpu", lambda: True)
    for mod, name in ((jdog, "dog_and_mask_pallas"),
                      (jrefine, "refine_candidates_pallas"),
                      (jod, "orient_and_describe_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    img = make_test_image(128, 192, seed=62)
    kw = dict(num_octaves=1, thresh=2.0, max_pts=1024, fast_gradients=True)
    jd = jax.jit(jpl._extract_sift_traced, static_argnames="params")(
        jnp.asarray(img), JaxSiftParams(**kw))
    td = ct.extract_sift(img, ct.SiftParams(**kw), device="cpu")
    nj, nt = int(jd.num_pts), int(td.num_pts)
    assert nj > 30 and nt > 30

    def oriented(d, n):
        f = [np.asarray(getattr(d, k))[:n] for k in ("xpos", "ypos", "scale", "orientation")]
        return dict(zip(zip(*(np.round(v, 2) for v in f[:3]), np.round(f[3], 0)),
                        np.asarray(d.data)[:n]))

    oj, ot = oriented(jd, nj), oriented(td, nt)
    kj = {k[:3] for k in oj}
    kt = {k[:3] for k in ot}
    assert len(kj & kt) / max(len(kj), len(kt)) >= 0.97
    shared = oj.keys() & ot.keys()
    assert len(shared) >= 0.9 * max(len(oj), len(ot))
    row = np.array([np.abs(oj[k] - ot[k]).max() for k in shared])
    assert np.median(row) < 4e-3 and row.max() < 2e-2, row
