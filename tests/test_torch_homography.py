"""Small solves, RANSAC and refinement of the port against the JAX package,
with the JAX random draws fed to the port's quad sampler."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scoring_cases
from cudasift_tpu import sift_data as jsd
from cudasift_tpu.ops import homography as jhom
from cudasift_tpu.ops import linalg as jlin

from cudasift_tpu_torch.convert import sift_data_from_numpy
from cudasift_tpu_torch.ops import homography as thom
from cudasift_tpu_torch.ops import linalg as tlin
from cudasift_tpu_torch.ops.cuda import ransac
from cudasift_tpu_torch.utils.synth import corner_error, known_homography

H_IMG, W_IMG = 192, 256


def test_solve_batched_matches_jax():
    rng = np.random.default_rng(31)
    a = (rng.standard_normal((64, 8, 8)) + 4 * np.eye(8)).astype(np.float32)
    b = rng.standard_normal((64, 8)).astype(np.float32)
    ours = tlin.solve_batched(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jlin.solve_batched(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours, np.linalg.solve(a, b[..., None])[..., 0], rtol=1e-3, atol=1e-4)


def test_weighted_lstsq8_matches_jax():
    rng = np.random.default_rng(32)
    ya = rng.standard_normal((200, 8)).astype(np.float32)
    yb = rng.standard_normal((200, 8)).astype(np.float32)
    bx = rng.standard_normal(200).astype(np.float32)
    by = rng.standard_normal(200).astype(np.float32)
    w = np.stack([(rng.uniform(size=200) < 0.7), np.zeros(200, bool)]).astype(np.float32)
    w[1, :3] = 1.0                                          # < 4 rows: not ok
    a, ok = tlin.weighted_lstsq8(*(torch.tensor(v) for v in (ya, yb, w, bx, by)))
    for i in range(2):
        ja, jok = jlin.weighted_lstsq8(jnp.asarray(ya), jnp.asarray(yb), jnp.asarray(w[i]),
                                       jnp.asarray(bx), jnp.asarray(by))
        assert bool(ok[i]) == bool(jok)
        if bool(jok):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    assert bool(ok[0]) and not bool(ok[1])


def matched_points(seed=33, n=300, cap=512):
    """SiftData fields of matched pairs under the known homography: 0.3 px
    noise, 30% outliers, and an ambiguity gate that passes about 60%."""
    rng = np.random.default_rng(seed)
    hm = known_homography(H_IMG, W_IMG)
    x1 = rng.uniform(0, W_IMG, n)
    y1 = rng.uniform(0, H_IMG, n)
    p = hm @ np.stack([x1, y1, np.ones(n)])
    x2 = p[0] / p[2] + rng.normal(0, 0.3, n)
    y2 = p[1] / p[2] + rng.normal(0, 0.3, n)
    out = rng.uniform(size=n) < 0.3
    x2[out] = rng.uniform(0, W_IMG, out.sum())
    y2[out] = rng.uniform(0, H_IMG, out.sum())
    arrays = {f.name: np.array(getattr(jsd.init_sift_data(cap), f.name))
              for f in dataclasses.fields(jsd.SiftData)}
    arrays["num_pts"] = np.int32(n)
    for name, v in (("xpos", x1), ("ypos", y1), ("match_xpos", x2), ("match_ypos", y2),
                    ("score", rng.uniform(0.5, 1.0, n)),
                    ("ambiguity", rng.uniform(0.4, 1.0, n))):
        arrays[name][:n] = v.astype(np.float32)
    arrays["match"][:n] = np.arange(n)
    return arrays, hm


def normalized(hm):
    hm = np.asarray(hm, np.float64)
    hm = hm / hm[2, 2]
    return hm / np.linalg.norm(hm)


def test_find_and_improve_homography_match_jax(monkeypatch):
    arrays, hm = matched_points()
    jdata = jsd.SiftData(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tdata = sift_data_from_numpy(arrays)
    loops = 512
    key = jax.random.PRNGKey(0)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (loops, 4))))
    # The port's sampler takes JAX's uniform draws instead of its generator's.
    monkeypatch.setattr(thom, "_uniform_draws", lambda gen, num_loops, device: u.to(device))
    jh, jnm = jhom.find_homography(jdata, key, num_loops=loops, min_score=0.0,
                                   max_ambiguity=0.8, thresh=5.0)
    th, tnm = thom.find_homography(tdata, None, num_loops=loops, min_score=0.0,
                                   max_ambiguity=0.8, thresh=5.0)
    assert np.abs(normalized(th.numpy()) - normalized(jh)).max() < 1e-3
    assert corner_error(th.numpy(), np.asarray(jh), H_IMG, W_IMG) < 0.5
    assert abs(int(tnm) - int(jnm)) <= 2

    start = jnp.asarray(np.asarray(jh) + np.diag([1e-3, -1e-3, 0.0]))
    jh2, jfit, jerr = jhom.improve_homography(jdata, start, 5, 0.0, 0.8, 3.0)
    th2, tfit, terr = thom.improve_homography(tdata, torch.tensor(np.asarray(start)),
                                              5, 0.0, 0.8, 3.0)
    assert np.abs(normalized(th2.numpy()) - normalized(jh2)).max() < 1e-3
    assert corner_error(th2.numpy(), np.asarray(jh2), H_IMG, W_IMG) < 0.5
    assert abs(int(tfit) - int(jfit)) <= 2
    live = np.asarray(jerr) < 3.0
    np.testing.assert_allclose(terr.numpy()[live], np.asarray(jerr)[live], atol=0.05)
    assert corner_error(th2.numpy(), hm, H_IMG, W_IMG) < 0.5


def test_distinct_quads_match_jax():
    key = jax.random.PRNGKey(3)
    for n in (3, 8, 9, 40):
        ref = np.asarray(jhom._sample_distinct_quads(key, 256, jnp.int32(n)))
        u = torch.tensor(np.asarray(jax.random.uniform(key, (256, 4))))
        ours = thom._distinct_quads(u, torch.tensor(n, dtype=torch.int32)).numpy()
        np.testing.assert_array_equal(ours, ref)
        if n >= 8:
            assert all(len(set(q)) == 4 for q in ours.tolist())


def test_split_sampler_draws_as_before():
    """The draws made outside the program and the quads made inside it are,
    for a fixed generator (or the default one), what one sampler made before
    the split, and leave the generator in the same state."""
    def sample_in_one(generator, num_loops, num_valid):
        gdev = generator.device if generator is not None else torch.device("cpu")
        u = torch.rand((num_loops, 4), generator=generator, device=gdev)
        return thom._distinct_quads(u.to(num_valid.device), num_valid)

    n = torch.tensor(37, dtype=torch.int32)
    g_old, g_new = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    for loops in (64, 1024):
        old = sample_in_one(g_old, loops, n)
        new = thom._distinct_quads(thom._uniform_draws(g_new, loops, n.device), n)
        assert torch.equal(old, new)
    assert torch.equal(torch.rand(4, generator=g_old), torch.rand(4, generator=g_new))
    torch.manual_seed(12)
    old = sample_in_one(None, 128, n)
    torch.manual_seed(12)
    assert torch.equal(old, thom._distinct_quads(thom._uniform_draws(None, 128, n.device), n))


def test_port_recovers_known_transform_and_gates_small_sets():
    arrays, hm = matched_points(seed=34)
    data = sift_data_from_numpy(arrays)
    gen = torch.Generator().manual_seed(5)
    h1, nm = thom.find_homography(data, gen, num_loops=1024, min_score=0.0,
                                  max_ambiguity=0.8, thresh=5.0)
    h2, nfit, err = thom.improve_homography(data, h1, 5, 0.0, 0.8, 3.0)
    assert corner_error(h2.numpy(), hm, H_IMG, W_IMG) < 0.5
    assert int(nm) > 150 and int(nfit) > 150
    assert err.shape == (512,) and bool(torch.isfinite(err).all())
    # Fewer than 8 gated pairs: identity and no matches.
    arrays["ambiguity"][:] = 1.0
    arrays["ambiguity"][:7] = 0.1
    h, nm = thom.find_homography(sift_data_from_numpy(arrays), gen, num_loops=64,
                                 min_score=0.0, max_ambiguity=0.8, thresh=5.0)
    np.testing.assert_array_equal(h.numpy(), np.eye(3, dtype=np.float32))
    assert int(nm) == 0


@pytest.mark.parametrize("field", ["num_loops", "min_score", "max_ambiguity", "thresh"])
def test_homography_params_defaults_mirror_jax(field):
    from cudasift_tpu.config import HomographyParams as JParams
    from cudasift_tpu_torch.config import HomographyParams as TParams

    assert getattr(TParams(), field) == getattr(JParams(), field)


@pytest.mark.parametrize("num_h,num_pts,plant", scoring_cases.CASES, ids=scoring_cases.IDS)
def test_scoring_wrapper_matches_jax(num_h, num_pts, plant):
    """``ops.cuda.ransac.inlier_counts`` on CPU tensors (its plain version)
    against the JAX package's scoring: counts equal, MSAC sums to 1e-6; a
    ragged ``num_pts`` (300 is no multiple of the kernel's 256-point split)
    counts only the live points."""
    h8, fields = scoring_cases.scoring_case(num_h, num_pts, plant)
    valid = np.arange(fields[0].shape[0]) < num_pts
    jc, jm = jhom._inlier_counts(jnp.asarray(h8), *(jnp.asarray(f)[None, :] for f in fields),
                                 jnp.asarray(valid), 5.0)
    counts, msac = ransac.inlier_counts(
        torch.tensor(h8), *(torch.tensor(f) for f in fields),
        torch.tensor(num_pts, dtype=torch.int32), torch.tensor(5.0))
    assert counts.dtype == torch.int64 and msac.dtype == torch.float32
    assert counts.shape == msac.shape == (num_h,)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(msac.numpy(), np.asarray(jm), rtol=1e-6, atol=0)
    if num_pts == 0:
        assert not counts.any() and not msac.any()
    if plant is not None:
        assert bool(torch.isfinite(msac).all())
    if num_h == 10000:                       # both near and far hypotheses
        assert int(counts.min()) == 0 and int(counts.max()) > 150
