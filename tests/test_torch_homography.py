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
from cudasift_tpu_torch.ops.cuda import lstsq, ransac
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


def dlt_rows(nx1, ny1, nx2, ny2):
    """The float32 DLT rows (ya, yb) and right-hand sides (bx, by) of the
    point pairs, as the homography programs build them."""
    one, zero = np.ones_like(nx1), np.zeros_like(nx1)
    ya = np.stack([nx1, ny1, one, zero, zero, zero, -nx1 * nx2, -ny1 * nx2], 1)
    yb = np.stack([zero, zero, zero, nx1, ny1, one, -nx1 * ny2, -ny1 * ny2], 1)
    return tuple(np.ascontiguousarray(v, np.float32) for v in (ya, yb, nx2, ny2))


def refit_case(seed, n, num_w):
    """Hartley-scale rows of n noisy pairs under a homography and ``num_w``
    weightings in {0, 1}, about 70% of the rows each."""
    rng = np.random.default_rng(seed)
    nx1, ny1 = rng.uniform(-1.5, 1.5, (2, n))
    hm = np.array([[1.1, 0.05, 0.1], [-0.04, 0.9, -0.2], [0.05, -0.03, 1.0]])
    q = hm @ np.stack([nx1, ny1, np.ones(n)])
    nx2, ny2 = q[:2] / q[2] + rng.normal(0, 1e-3, (2, n))
    w = (rng.uniform(size=(num_w, n)) < 0.7).astype(np.float32)
    return dlt_rows(nx1, ny1, nx2, ny2), w


def lstsq64(ya, yb, w, bx, by):
    """numpy's float64 least squares of one weighting (w in {0, 1})."""
    keep = np.concatenate([w, w]) > 0
    y = np.concatenate([ya, yb]).astype(np.float64)[keep]
    b = np.concatenate([bx, by]).astype(np.float64)[keep]
    return np.linalg.lstsq(y, b, rcond=None)[0]


@pytest.mark.parametrize("num_w", [1, 3])
def test_weighted_lstsq8_solves_each_weighting(num_w):
    """The QR solves each of B weightings as numpy's float64 least squares
    does, to float32's rounding, and one call of B weightings gives each the
    bits of a call of its own."""
    (ya, yb, bx, by), w = refit_case(40, 300, num_w)
    a, ok = tlin.weighted_lstsq8(*(torch.tensor(v) for v in (ya, yb, w, bx, by)))
    assert a.dtype == torch.float32 and ok.dtype == torch.bool
    assert a.shape == (num_w, 8) and ok.shape == (num_w,) and bool(ok.all())
    for i in range(num_w):
        np.testing.assert_allclose(a[i].numpy(), lstsq64(ya, yb, w[i], bx, by),
                                   rtol=1e-5, atol=1e-6)
        one, one_ok = tlin.weighted_lstsq8(*(torch.tensor(v) for v in (ya, yb, w[i:i + 1],
                                                                        bx, by)))
        assert bool(one_ok[0]) and torch.equal(a[i], one[0])


@pytest.mark.parametrize("weighted", [0, 1, 2, 3, 4])
def test_weighted_lstsq8_needs_four_weighted_points(weighted):
    """Fewer than 4 weighted points: not ok; 4 points (8 rows for 8
    unknowns) solve."""
    (ya, yb, bx, by), _ = refit_case(41, 50, 1)
    w = np.zeros((1, 50), np.float32)
    w[0, 10:10 + weighted] = 1.0
    _, ok = tlin.weighted_lstsq8(*(torch.tensor(v) for v in (ya, yb, w, bx, by)))
    assert bool(ok[0]) == (weighted == 4)


@pytest.mark.parametrize("axis", [0, 1])
def test_weighted_lstsq8_collinear_points_are_not_ok(axis):
    """Source points on a coordinate axis (the other coordinate exactly 0)
    leave a column of A exactly 0: its R_jj is 0 and the solve is not ok,
    in every weighting over them; a weighting of the same call over sound
    rows is unaffected."""
    rng = np.random.default_rng(42)
    nx1, ny1, nx2, ny2 = rng.uniform(-1.5, 1.5, (4, 60)).astype(np.float32)
    (nx1, ny1)[1 - axis][:40] = 0.0                         # the first 40 on the axis
    ya, yb, bx, by = dlt_rows(nx1, ny1, nx2, ny2)
    w = np.zeros((3, 60), np.float32)
    w[0, :40] = 1.0                                          # collinear
    w[1, :20] = 1.0                                          # collinear
    w[2, :] = 1.0                                            # the whole set: solvable
    a, ok = tlin.weighted_lstsq8(*(torch.tensor(v) for v in (ya, yb, w, bx, by)))
    assert ok.tolist() == [False, False, True]
    assert bool(torch.isfinite(a[2]).all())


@pytest.mark.parametrize("seed", [43, 44, 45])
def test_weighted_lstsq8_three_points_repeated(seed):
    """Three distinct pairs repeated: 6 independent rows for 8 unknowns, and
    the solve is not ok."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.5, 1.5, (3, 4)).astype(np.float32)
    idx = np.arange(30) % 3
    ya, yb, bx, by = dlt_rows(*(p[idx, k] for k in range(4)))
    w = np.ones((1, 30), np.float32)
    _, ok = tlin.weighted_lstsq8(*(torch.tensor(v) for v in (ya, yb, w, bx, by)))
    assert not bool(ok[0])


@pytest.mark.parametrize("num_pts", [0, 5, 130, 200])
def test_weighted_lstsq8_rows_past_num_pts_change_nothing(num_pts):
    """Rows at or past ``num_pts``, NaN with weight 1 there, give the bits of
    the same rows zeroed with weight 0 and no count; CPU tensors take the
    plain twin through the kernel's wrapper."""
    (ya, yb, bx, by), w = refit_case(47, 200, 3)
    dead = np.arange(200) >= num_pts
    clean = [v.copy() for v in (ya, yb, w, bx, by)]
    poured = [v.copy() for v in (ya, yb, w, bx, by)]
    for i in (0, 1, 3, 4):
        clean[i][dead] = 0.0
        poured[i][dead] = np.nan
    clean[2][:, dead] = 0.0
    poured[2][:, dead] = 1.0
    got = lstsq.weighted_lstsq8(*(torch.tensor(v) for v in poured),
                                torch.tensor(num_pts, dtype=torch.int32))
    ref = tlin.weighted_lstsq8(*(torch.tensor(v) for v in clean))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[1].tolist() == (w[:, :num_pts].sum(axis=1) >= 4).tolist()


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


def test_programs_stay_within_the_benchmarks_limits_of_its_reference():
    """RANSAC and IRLS of the port against the benchmark's frozen plain
    reference (``siftbench/reference/homography.py``) on the same matches
    and draws: on CPU tensors both take the plain QR, the reference's own
    refit, so every compared number of ``siftbench/limits/1080p-pairs.json``
    reads 0."""
    import json
    from pathlib import Path

    from siftbench import compare
    from siftbench.reference import homography as ref
    from siftbench.reference.precision import FLOAT32

    limits = json.loads((Path(__file__).resolve().parents[1] / "siftbench" / "limits"
                         / "1080p-pairs.json").read_text())["check"]
    arrays, _ = matched_points(seed=48, n=400)
    data = sift_data_from_numpy(arrays)
    u = torch.rand((512, 4), generator=torch.Generator().manual_seed(6))
    got = thom._find_homography_jit(thom._pairs(data), u,
                                    thom._gates(0.0, 0.8, 5.0, data.device))
    want = ref.find_homography(data, u, 0.0, 0.8, 5.0, FLOAT32)
    numbers = {f"ransac.{k}": v for k, v in compare.ransac(got, want, H_IMG, W_IMG).items()}
    fit = thom.improve_homography(data, got[0], 5, 0.0, 0.8, 3.0)
    want_fit = ref.improve_homography(data, got[0], 5, 0.0, 0.8, 3.0, FLOAT32)
    numbers.update({f"irls.{k}": v for k, v in compare.refinement(
        fit, want_fit, 400, 3.0, H_IMG, W_IMG).items()})
    assert sorted(numbers) == sorted(k for k in limits if k.startswith(("ransac.", "irls.")))
    assert all(v == 0.0 for v in numbers.values()), numbers


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
