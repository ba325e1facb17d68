"""Plain version of the compaction kernel (K8) against the JAX package's
compaction, bit for bit (the bar ``tests/test_pallas_compact.py`` sets for
the TPU kernel against its twin), the wrapper's dispatch on CPU tensors,
and a numpy restatement of the kernel's ranking (segment counts, block
offsets, in-word, warp and block prefixes) at its own widths against both,
so that the algorithm is held here, where the kernel cannot run."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudasift_tpu.ops.detect import compact_mask as jax_compact
from cudasift_tpu.ops.pallas.compact import compact_mask_pallas

from cudasift_tpu_torch.ops.cuda import compact


def check(mask, capacity):
    launches = compact.KERNEL.launches
    idx, count, total = compact.compact_mask(torch.as_tensor(mask), capacity)
    assert compact.KERNEL.launches == launches          # CPU tensors: plain version
    assert idx.dtype == count.dtype == total.dtype == torch.int32
    ref_idx, ref_count, ref_total = jax_compact(jnp.asarray(mask), capacity, with_total=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert int(count) == int(ref_count) == min(int(mask.sum()), capacity)
    assert int(total) == int(ref_total) == int(mask.sum())
    return int(count)


@pytest.mark.parametrize("shape,density,capacity,expect", [
    ((5, 96, 160), 0.001, 1024, "under"),        # undercapacity
    ((5, 96, 160), 0.01, 256, "full"),           # saturation: total > capacity
    ((5, 64, 128), 0.0, 128, "empty"),           # empty mask
    ((5, 200, 334), 0.003, 384, None),           # not a multiple of 4096 entries
    ((5, 30, 40), 0.5, 512, "full"),             # dense, tiny
])
def test_compact_plain_matches_jax(shape, density, capacity, expect):
    rng = np.random.default_rng(61)
    mask = rng.random(shape) < density
    count = check(mask, capacity)
    if expect == "under":
        assert 0 < count < capacity
    elif expect == "full":
        assert count == capacity
    elif expect == "empty":
        assert count == 0


def test_compact_plain_matches_pallas_kernel():
    """One small case against the TPU kernel itself in interpret mode."""
    mask = np.random.default_rng(62).random((5, 24, 40)) < 0.02
    idx, count, _ = compact.compact_mask(torch.as_tensor(mask), 128)
    ref_idx, ref_count = compact_mask_pallas(jnp.asarray(mask), 128, interpret=True)
    assert int(count) == int(ref_count) > 0
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


CSRC = Path(compact.__file__).resolve().parents[2] / "csrc" / "compact.cu"


def test_kernel_widths_match_the_source():
    src = CSRC.read_text()
    for name, value in (("THREADS", compact.THREADS), ("VEC", compact.VECTOR),
                        ("STEPS", compact.STEPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert compact.SEGMENT == 16384
    assert compact.segments(0, 0) == 1 and compact.segments(compact.SEGMENT, 1) == 2


def kernel_model(flat: np.ndarray, capacity: int, misalign: int):
    """The two launches of ``csrc/compact.cu`` in numpy: ``flat`` (n,) bytes
    at an address ``misalign`` bytes past a 16-byte boundary. Returns (idx,
    count, total, ranks of all set entries in raster order)."""
    n = flat.size
    vec, threads, steps = compact.VECTOR, compact.THREADS, compact.STEPS
    warps = threads // 32
    nseg = compact.segments(n, misalign)
    grid = np.zeros(nseg * compact.SEGMENT, np.uint8)
    grid[misalign:misalign + n] = flat
    # Byte q of the word that thread t of block b loads in step k.
    words = grid.reshape(nseg, steps, threads, vec) != 0
    # Launch 1: one count per segment.
    seg_count = words.sum(axis=(1, 2, 3))
    # Launch 2: each block's offset and the total from the counts ...
    offset = np.cumsum(seg_count) - seg_count
    total = int(seg_count.sum())
    count = min(total, capacity)
    # ... then per step a thread's count, its warp's exclusive scan, the
    # warps before it and the earlier steps of the block.
    cnt = words.sum(axis=-1).reshape(nseg, steps, warps, 32)
    lane_incl = np.cumsum(cnt, axis=-1)
    lane_excl = (lane_incl - cnt).reshape(nseg, steps, threads)
    warp_total = lane_incl[..., -1]
    warp_before = np.repeat(np.cumsum(warp_total, axis=-1) - warp_total, 32, axis=-1)
    step_total = warp_total.sum(axis=-1)
    run = offset[:, None] + np.cumsum(step_total, axis=-1) - step_total
    in_word = np.cumsum(words, axis=-1) - words
    rank = run[:, :, None, None] + (warp_before + lane_excl)[..., None] + in_word
    b, k, t, q = np.nonzero(words)
    r = rank[b, k, t, q]
    flat_index = (b * steps * threads + k * threads + t) * vec + q - misalign
    idx = np.zeros(capacity, np.int32)
    keep = r < capacity
    idx[r[keep]] = flat_index[keep]
    return idx, count, total, r[np.argsort(flat_index)]


SEG = 16384


@pytest.mark.parametrize("n,density,capacity,misalign", [
    (SEG, 1.0, SEG, 0),               # all set, one whole segment, exactly full
    (1, 1.0, 4, 5),                   # one entry, inside the first partial word
    (15, 1.0, 32, 0),                 # a partial word only
    (16, 0.5, 32, 0),                 # exactly one word
    (17, 0.5, 32, 15),                # a word and a byte, misaligned
    (SEG + 1, 0.01, 512, 0),          # one entry into a second segment
    (SEG + 1, 1.0, 1024, 3),          # all set, saturating, misaligned like big[3:]
    (5 * 67 * 121, 0.0, 128, 0),      # nothing set at an octave's size
    (5 * 135 * 241, 0.002, 256, 7),   # sparse, three segments
    (5 * 135 * 241, 0.3, 70000, 0),   # dense, 48,000 set: under capacity
    (5 * 135 * 241, 0.3, 4096, 9),    # dense, saturating
])
def test_kernel_ranking_matches_plain_and_jax(n, density, capacity, misalign):
    rng = np.random.default_rng(63 + n)
    flat = rng.random(n) < density
    if density > 0 and n > 1:
        flat[[0, -1]] = True              # the first and last entries are set
    raw = flat.astype(np.uint8) * rng.integers(1, 256, n, dtype=np.uint8)   # any non-zero byte
    idx, count, total, ranks = kernel_model(raw, capacity, misalign)
    assert total == int(flat.sum()) and count == min(total, capacity)
    np.testing.assert_array_equal(ranks, np.arange(total))     # every rank once, in order
    ref = compact.compact_mask(torch.as_tensor(flat), capacity)
    np.testing.assert_array_equal(idx, ref[0].numpy())
    assert count == int(ref[1]) and total == int(ref[2])
    jidx, jcount, jtotal = jax_compact(jnp.asarray(flat), capacity, with_total=True)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    assert count == int(jcount) and total == int(jtotal)
