"""Plain PyTorch stages of the port against the JAX package's XLA versions:
convolutions, detection (mask, compaction, refinement), texture sampling,
the atan2 polynomials and histogram peaks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudasift_tpu.config import laplace_kernels
from cudasift_tpu.ops import convolve as jconv
from cudasift_tpu.ops import detect as jdet
from cudasift_tpu.ops import orient as jori
from cudasift_tpu.ops import texture as jtex
from cudasift_tpu.ops.pallas.orient import _atan2_poly as jatan2_poly

from cudasift_tpu_torch.ops import convolve as tconv
from cudasift_tpu_torch.ops import detect as tdet
from cudasift_tpu_torch.ops import orient as tori
from cudasift_tpu_torch.ops import texture as ttex
from cudasift_tpu_torch.utils.synth import make_test_image


def t(a):
    return torch.tensor(np.asarray(a))


def n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def dog_of(img, num_octaves=1):
    blur = jconv.blur_multi(jnp.asarray(img), laplace_kernels(num_octaves)[0])
    return np.asarray(blur[1:] - blur[:-1])


@pytest.mark.parametrize("h,w", [(70, 150), (33, 47)])
def test_convolve_matches_jax(h, w):
    img = make_test_image(h, w, seed=1)
    ktab = laplace_kernels(3)[1]
    taps5 = np.asarray([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)
    pairs = [
        (tconv.low_pass(t(img), 1.0), jconv.low_pass(jnp.asarray(img), 1.0)),
        (tconv.scale_down(t(img)), jconv.scale_down(jnp.asarray(img))),
        (tconv.scale_up(t(img)), jconv.scale_up(jnp.asarray(img))),
        (tconv.blur_multi(t(img), ktab), jconv.blur_multi(jnp.asarray(img), ktab)),
        (tconv.sep_conv_clamp(t(img), taps5), jconv.sep_conv_clamp(jnp.asarray(img), taps5)),
    ]
    for ours, ref in pairs:
        assert ours.shape == ref.shape
        np.testing.assert_allclose(n(ours), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("thresh,edge_limit", [(0.8, 10.0), (0.8, None), (2.0, 10.0)])
def test_extrema_mask_matches_jax(thresh, edge_limit):
    dog = dog_of(make_test_image(80, 144, seed=2))
    ours = tdet.extrema_mask(t(dog), thresh, edge_limit)
    ref = jdet.extrema_mask(jnp.asarray(dog), thresh, edge_limit)
    assert int(ours.sum()) > 10
    np.testing.assert_array_equal(n(ours), np.asarray(ref))


@pytest.mark.parametrize("capacity", [128, 384, 4096])
def test_compact_mask_matches_jax(capacity):
    rng = np.random.default_rng(3)
    mask = rng.uniform(size=(5, 40, 60)) < 0.03        # ~360 set: 128 overflows
    ours = tdet.compact_mask(t(mask), capacity, with_total=True)
    ref = jdet.compact_mask(jnp.asarray(mask), capacity, with_total=True)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    assert int(ours[2]) == int(mask.sum())
    assert int(ours[1]) == min(capacity, int(mask.sum()))
    idx, cnt = tdet.compact_mask(t(mask), capacity)
    np.testing.assert_array_equal(n(idx), np.asarray(ref[0]))


def edge_hugging_candidates(mask, h, w, capacity):
    """Natural candidates plus hand-placed ones on every image edge."""
    idx, cnt = jdet.compact_mask(jnp.asarray(mask), capacity)
    forced = [s * h * w + y * w + x for s in (0, 4) for y in (1, h - 2)
              for x in (1, 2, w // 2, w - 3, w - 2)]
    idx = np.concatenate([forced, np.asarray(idx)])[:capacity].astype(np.int32)
    return idx, np.int32(min(int(cnt) + len(forced), capacity))


def test_refine_candidates_matches_jax():
    h, w = 80, 144
    dog = dog_of(make_test_image(h, w, seed=4))
    mask = np.asarray(jdet.extrema_mask(jnp.asarray(dog), 2.0, 10.0))
    idx, cnt = edge_hugging_candidates(mask, h, w, 256)
    assert cnt > 24
    for lowest in (0.0, 1.3):
        ref = jdet.refine_candidates(jnp.asarray(dog), jnp.asarray(idx),
                                     jnp.asarray(cnt), 10.0, lowest)
        ours = tdet.refine_candidates(t(dog), t(idx), torch.tensor(cnt), 10.0, lowest)
        np.testing.assert_array_equal(n(ours.valid), np.asarray(ref.valid))
        assert n(ours.valid)[:cnt].any() and not n(ours.valid)[cnt:].any()
        for name in ("xpos", "ypos", "scale", "sharpness", "edgeness"):
            np.testing.assert_allclose(n(getattr(ours, name)),
                                       np.asarray(getattr(ref, name)),
                                       rtol=3e-7, atol=0, err_msg=name)


def test_tex2d_matches_jax():
    rng = np.random.default_rng(5)
    img = make_test_image(40, 50, seed=5)
    x = rng.uniform(-3, 53, 500).astype(np.float32)
    y = rng.uniform(-3, 43, 500).astype(np.float32)
    np.testing.assert_allclose(
        n(ttex.tex2d(t(img), t(x), t(y))),
        np.asarray(jtex.tex2d(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-6, atol=1e-4)


def test_atan2_polynomials_match_jax():
    rng = np.random.default_rng(6)
    y = rng.standard_normal(2000).astype(np.float32)
    x = rng.standard_normal(2000).astype(np.float32)
    x[:20] = 0.0
    y[10:30] = 0.0
    for ours, ref in ((ttex.fast_atan2, jtex.fast_atan2),
                      (ttex.atan2_poly, jatan2_poly)):
        np.testing.assert_allclose(n(ours(t(y), t(x))),
                                   np.asarray(ref(jnp.asarray(y), jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(ttex.atan2_poly(t(y), t(x))), np.arctan2(y, x),
                               atol=2e-6)


def test_histogram_peaks_matches_jax():
    rng = np.random.default_rng(7)
    hist = rng.uniform(0, 10, (64, 32)).astype(np.float32)
    hist[0] = 0.0                       # flat: no peak
    hist[1] = 1.0
    hist[2, [3, 19]] = 50.0             # exact tie between two peaks
    ours = tori.histogram_peaks(t(hist))
    ref = jori.histogram_peaks(jnp.asarray(hist))
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(n(ours[2]), np.asarray(ref[2]))
