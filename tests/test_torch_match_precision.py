"""The arithmetic of the two matcher kernels, restated on the CPU: K4's
3xTF32 split (``ops.match.split_tf32``, rounded as ``cvt.rna.tf32.f32``)
against float64 and the JAX package's exact tier (its Pallas kernel in
interpret mode at Precision.HIGHEST, and its XLA twin), K5's bfloat16x3
split on the JAX package's near-tie case, and the constants the wrappers
share with the CUDA sources."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudasift_tpu.ops import match as jmatch
from cudasift_tpu.ops.pallas.match import match_descriptors_pallas

from cudasift_tpu_torch.ops import match as tmatch
from cudasift_tpu_torch.ops.cuda import match

CSRC = Path(tmatch.__file__).resolve().parent.parent / "csrc"


def unit_rows(rng, n):
    d = rng.standard_normal((n, 128)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def chained(pairs, step):
    """The sum of the products of each (a, b) pair as the kernels form it:
    one k step of ``step`` columns at a time, every pair's step products
    summed (in float64: one MMA sums its step before it rounds) and then
    added to a float32 accumulator, the pairs of one step in order. The
    tensor cores' own rounding inside a step is not modelled."""
    acc = torch.zeros((pairs[0][0].shape[0], pairs[0][1].shape[0]), dtype=torch.float32)
    for k in range(0, 128, step):
        for a, b in pairs:
            acc = acc + (a[:, k:k + step].double() @ b[:, k:k + step].double().T).float()
    return acc


def tf32x3(d1, d2):
    """K4's default tier: hh + (hl + lh) of the tf32 split, in the kernel's
    m16n8k8 steps."""
    a_big, a_small = tmatch.split_tf32(torch.as_tensor(d1))
    b_big, b_small = tmatch.split_tf32(torch.as_tensor(d2))
    hh = chained([(a_big, b_big)], 8)
    return (hh + chained([(a_big, b_small), (a_small, b_big)], 8)).numpy()


def bf16x3(d1, d2):
    """K5's sweep scores: the same sums of the bfloat16 split, in the
    kernel's m16n8k16 steps."""
    a_hi, a_lo = tmatch.split_bf16(torch.as_tensor(d1))
    b_hi, b_lo = tmatch.split_bf16(torch.as_tensor(d2))
    hh = chained([(a_hi, b_hi)], 16)
    return (hh + chained([(a_hi, b_lo), (a_lo, b_hi)], 16)).numpy()


@pytest.mark.parametrize("x, want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),             # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),              # below the tie: down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),           # odd tie: away, not to even
    (0.1, 0.0999755859375),
    (0.0, 0.0),
])
def test_split_tf32_rounds_as_cvt_rna(x, want):
    big, small = tmatch.split_tf32(torch.tensor([x], dtype=torch.float32))
    assert float(big[0]) == want
    bits = big.view(torch.int32) | small.view(torch.int32)
    assert int(bits[0]) & 0x1FFF == 0 or float(small[0]) == 0.0


def test_split_tf32_keeps_22_bits():
    rng = np.random.default_rng(81)
    x = torch.as_tensor(rng.standard_normal(4096).astype(np.float32))
    big, small = tmatch.split_tf32(x)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


def test_tf32x3_scores_are_float32_exact():
    """1024 x 1024 unit rows: the 3xTF32 scores lie within 5e-7 of float64,
    and their argmax equals the JAX package's exact tier in both its
    forms."""
    rng = np.random.default_rng(82)
    d1, d2 = unit_rows(rng, 1024), unit_rows(rng, 1024)
    s = tf32x3(d1, d2)
    ref = d1.astype(np.float64) @ d2.astype(np.float64).T
    assert np.abs(s - ref).max() <= 5e-7
    idx = s.argmax(axis=1)
    np.testing.assert_array_equal(idx, ref.argmax(axis=1))
    n = jnp.int32(1024)
    pallas = match_descriptors_pallas(jnp.asarray(d1), jnp.asarray(d2), n, n, interpret=True)
    xla = jmatch.match_descriptors(jnp.asarray(d1), jnp.asarray(d2), n, n)
    for score, _, index in (pallas, xla):
        np.testing.assert_array_equal(idx, np.asarray(index))
        np.testing.assert_allclose(s.max(axis=1), np.asarray(score), rtol=0, atol=5e-7)


def flip_case():
    """The JAX package's adversarial near-tie (tests/test_pallas.py): row 40
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
    return np.stack([q] * 8), d2


def test_bf16_flip_case_tf32x3_keeps_the_exact_winner():
    """The margin is 1.04e-4 on scores near 128.5 (7 float32 ulps): the
    3xTF32 products summed in the kernel's steps keep it, the bfloat16x3
    ones lose it."""
    d1, d2 = flip_case()
    exact = d1.astype(np.float64) @ d2.astype(np.float64).T
    assert int(exact[0].argmax()) == 40
    s = tf32x3(d1, d2)
    assert int(s[0].argmax()) == 40
    np.testing.assert_allclose(s[0, [20, 40]], exact[0, [20, 40]], rtol=0, atol=3e-5)
    ranked = np.argsort(-bf16x3(d1, d2)[0], kind="stable")
    assert ranked[:2].tolist() == [20, 40]


def test_kernel_constants_match_the_sources():
    """The wrappers size their outputs and scratch from constants that the
    CUDA sources also hold."""
    k4 = (CSRC / "match.cu").read_text()
    k5 = (CSRC / "match_sweep.cu").read_text()
    assert re.search(rf"constexpr int SPLIT = {match.MATCH_SPLIT};", k4)
    assert re.search(rf"constexpr int CHUNK = {tmatch.SWEEP_CHUNK};", k5)
    rng = int(re.search(r"constexpr int RANGE = (\d+);", k5).group(1))
    assert rng % tmatch.SWEEP_CHUNK == 0
    tile = int(re.search(r"constexpr int BN = (\d+);", (CSRC / "match_tc.cuh").read_text())
               .group(1))
    assert tmatch.SWEEP_CHUNK % tile == 0 and match.MATCH_SPLIT % tile == 0


def test_timers_refuse_without_a_card(monkeypatch):
    from cudasift_tpu_torch.utils import timers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for timer in (timers.time_ms, timers.time_ms_loop, timers.time_ms_graph):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            timer(lambda: None)
