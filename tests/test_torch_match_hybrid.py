"""The hybrid exact matcher tier (``rescore_k``, K5): the port's plain path
against the JAX package's ``match_descriptors_pallas(rescore_k=8)`` in
interpret mode, its two adversarial cases (tests/test_pallas.py), the plain
sweep's candidates, and the wrapper's dispatch on CPU tensors."""

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudasift_tpu.ops.pallas.match import T2, match_descriptors_pallas

from cudasift_tpu_torch.ops import match as tmatch
from cudasift_tpu_torch.ops.cuda import match


def unit_rows(rng, n):
    d = rng.standard_normal((n, 128)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def hybrid(d1, d2, n1, n2):
    launches = match.SWEEP_KERNEL.launches
    out = match.match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2), n1, n2,
                                  rescore_k=8)
    assert match.SWEEP_KERNEL.launches == launches       # CPU tensors: plain version
    return [o.numpy() for o in out]


def pallas(d1, d2, n1, n2):
    out = match_descriptors_pallas(jnp.asarray(d1), jnp.asarray(d2), jnp.int32(n1),
                                   jnp.int32(n2), rescore_k=8, interpret=True)
    return [np.asarray(o) for o in out]


def test_hybrid_matches_pallas_and_exact_tier():
    rng = np.random.default_rng(71)
    d1, d2 = unit_rows(rng, 300), unit_rows(rng, 700)
    d2[[100, 613]] = d1[7]                     # a tie across chunks: lowest index wins
    n1, n2 = 290, 643
    score, amb, idx = hybrid(d1, d2, n1, torch.tensor(n2, dtype=torch.int32))
    ref = pallas(d1, d2, n1, n2)
    np.testing.assert_array_equal(idx[:n1], ref[2][:n1])
    np.testing.assert_allclose(score[:n1], ref[0][:n1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(amb[:n1], ref[1][:n1], rtol=1e-5, atol=1e-6)
    assert idx[7] == 100 and idx.max() < n2
    assert not score[n1:].any() and not idx[n1:].any()
    # The exact tier: same indices, float32 scores.
    es, ea, ei = (o.numpy() for o in tmatch.match_descriptors(
        torch.as_tensor(d1), torch.as_tensor(d2), n1, n2))
    np.testing.assert_array_equal(idx, ei)
    np.testing.assert_allclose(score, es, rtol=1e-6, atol=1e-7)


def test_sweep_candidates_top_two_per_chunk():
    rng = np.random.default_rng(72)
    d1, d2 = unit_rows(rng, 20), unit_rows(rng, 600)
    d2[[300, 301]] = d1[0]                     # equal best pair in chunk 1
    n2 = 520
    cs, ci = tmatch.sweep_candidates(torch.as_tensor(d1), torch.as_tensor(d2), 18, n2)
    assert cs.shape == ci.shape == (20, 6) and ci.dtype == torch.int32
    hi, lo = (t.numpy().astype(np.float64) for t in tmatch.split_bf16(torch.as_tensor(d1)))
    hi2, lo2 = (t.numpy().astype(np.float64) for t in tmatch.split_bf16(torch.as_tensor(d2)))
    full = hi @ hi2.T + (hi @ lo2.T + lo @ hi2.T)
    for r in range(18):
        for c in range(3):
            cols = np.arange(c * 256, (c + 1) * 256)
            s = np.where(cols < n2, full[r, np.minimum(cols, 599)], -1e30)
            order = np.lexsort((cols, -s))[:2]       # score down, column up
            np.testing.assert_array_equal(ci[r, 2 * c:2 * c + 2].numpy(), cols[order])
            np.testing.assert_allclose(cs[r, 2 * c:2 * c + 2].numpy(), s[order], rtol=1e-5)
    assert ci[0, 2].item() == 300 and ci[0, 3].item() == 301
    assert (cs[18:] == -1e30).all() and not ci[18:].any()
    # One live column in chunk 1, none in chunk 2: masked columns rank by
    # index, and a chunk's two candidates are always distinct columns.
    cs, ci = tmatch.sweep_candidates(torch.as_tensor(d1), torch.as_tensor(d2), 20, 257)
    assert (ci[:, 2:].numpy() == [256, 257, 512, 513]).all()
    assert (cs[:, 3:] == -1e30).all() and (cs[:, 2] > -1e30).all()


def test_hybrid_rescore_fixes_bf16_flip():
    """The adversarial near-tie of the JAX package's test: the bfloat16x3
    sweep ranks the exact loser first; the float32 rescore returns the true
    winner, index 40."""
    def split(v):
        hi = v.astype(ml_dtypes.bfloat16).astype(np.float64)
        lo = (v - hi.astype(np.float32)).astype(ml_dtypes.bfloat16)
        return hi, lo.astype(np.float64)

    q = np.full(128, 1.001, np.float32)

    def exact64(x):
        return float(q.astype(np.float64) @ x.astype(np.float64))

    def sweep64(x):
        qh, ql = split(q)
        xh, xl = split(x)
        return float(qh @ xh + qh @ xl + ql @ xh)

    cand_a = np.full(128, 1.0048125, np.float32)
    cand_a[:30] = np.float32(0.997)
    cand_b = np.full(128, 1.003, np.float32)
    diff = exact64(cand_a) - exact64(cand_b)
    cand_b[:100] += np.float32((diff + 1e-4) / 1.001 / 100)
    assert exact64(cand_b) > exact64(cand_a) and sweep64(cand_a) > sweep64(cand_b)

    d2 = np.random.default_rng(7).standard_normal((64, 128)).astype(np.float32) * 0.01
    d2[20] = cand_a
    d2[40] = cand_b
    d1 = np.stack([q] * 8)
    # The port's split rounds as the numpy construction does (lo residual
    # included), so its sweep is fooled the same way.
    hi, lo = tmatch.split_bf16(torch.as_tensor(d2[20:21]))
    np.testing.assert_array_equal(lo.numpy()[0], split(cand_a)[1].astype(np.float32))
    cs, ci = tmatch.sweep_candidates(torch.as_tensor(d1), torch.as_tensor(d2), 8, 64)
    assert ci[0, 0].item() == 20 and ci[0, 1].item() == 40
    for score, amb, idx in (hybrid(d1, d2, 8, 64), pallas(d1, d2, 8, 64)):
        assert int(idx[0]) == 40
        np.testing.assert_allclose(float(score[0]), exact64(cand_b), rtol=1e-6)
        np.testing.assert_allclose(float(amb[0]), exact64(cand_a) / (exact64(cand_b) + 1e-6),
                                   rtol=1e-5)


@pytest.mark.parametrize("n2", [T2 + 300])
def test_hybrid_duplicate_tiebreak_multitile(n2):
    """Exact duplicates of the best match in both of the TPU kernel's
    2048-column tiles: the lowest index wins, its duplicates are second."""
    rng = np.random.default_rng(3)
    d2 = unit_rows(rng, n2)
    q = d2[T2 + 100].copy()
    d2[50] = q
    d2[700] = q
    d1 = np.stack([q] * 4)
    for score, amb, idx in (hybrid(d1, d2, 4, n2), pallas(d1, d2, 4, n2)):
        assert list(idx) == [50] * 4
        np.testing.assert_allclose(amb, 1.0, rtol=1e-6)
