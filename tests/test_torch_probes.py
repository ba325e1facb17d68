"""Plain versions of the patch-acquisition kernels (P1) against a numpy
restatement of benchmarks/acquire_bench.py, and of the eight capability
probes (P2) against what each TPU probe in benchmarks/mosaic_probe.py
asserts. (The TPU scripts cannot run off the TPU.)"""

import numpy as np
import pytest
import torch

from cudasift_tpu_torch.ops.cuda import acquire, probes


def acquire_bench_numpy(img, oy, ox, rxy, do_roll):
    """acquire_bench.py:31-121 line by line: per block of 8 keypoints, the
    (56, 256) patch, optionally realigned by the two rolls, its (48, 64)
    window summed into row 0 of a (1, 8, 128) block (rows 1-7 zero here)."""
    n = oy.shape[0]
    out = np.zeros((n // 8, 8, 128), np.float32)
    for blk in range(n // 8):
        acc = np.zeros((1, 128), np.float32)
        for k in range(8):
            i = blk * 8 + k
            patch = img[oy[i]:oy[i] + 56, ox[i]:ox[i] + 256]
            if do_roll:
                ry, rx = rxy[i], rxy[i + 65536]
                a = np.roll(patch, (56 - ry) % 56, axis=0)[:48, :]
                a = np.roll(a, (256 - rx) % 256, axis=1)[:, :64]
            else:
                a = patch[:48, :64]
            acc = acc + a.sum(axis=0, keepdims=True)[:, :64].sum(axis=1, keepdims=True)
        out[blk, 0] = acc[0]
    return out


@pytest.mark.parametrize("roll", [False, True])
def test_acquire_plain_matches_bench(roll):
    img, oy, ox, rxy = acquire.bench_inputs(32, 72, 640, seed=3)
    assert img.shape == (72 + 56, 640 + 256)
    assert (oy % 8 == 0).all() and (ox % 128 == 0).all()
    ref = acquire_bench_numpy(img, oy, ox, rxy, roll)
    args = tuple(torch.as_tensor(a) for a in (img, oy, ox, rxy))
    before = {k: k.launches for k in acquire.KERNELS.values()}
    for staged in (True, False):
        got = acquire.acquire(*args, staged=staged, roll=roll)
        assert got.shape == (4, 8, 128)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
        assert not got[:, 1:].any()
    assert all(k.launches == before[k] for k in acquire.KERNELS.values())
    bench = acquire.acquire_bench(*args)
    assert set(bench) == {name for name, _, _ in acquire.VARIANTS}


def test_acquire_realignment_wraps_and_clamps():
    """Offsets past the bench's ranges: realignments wrap inside the
    aligned patch as the rolls do, and reads clamp to the image."""
    img = np.arange(64 * 300, dtype=np.float32).reshape(64, 300) % 97
    oy = np.array([0, 8, 16, 60, -5, 0, 3, 8], np.int32)
    ox = np.array([0, 128, 44, 250, 0, -9, 7, 0], np.int32)
    rxy = np.zeros(16, np.int32)
    rxy[:8] = [0, 7, 60, -3, 2, 9, 1, 55]
    rxy[8:] = [0, 127, 300, -1, 5, 200, 3, 250]
    got = acquire.acquire(*(torch.as_tensor(a) for a in (img, oy, ox, rxy)), roll=True)
    total = 0.0
    for i in range(8):
        rows = np.clip(oy[i] + (np.arange(48) + rxy[i]) % 56, 0, 63)
        cols = np.clip(ox[i] + (np.arange(64) + rxy[8 + i]) % 256, 0, 299)
        total += float(img[np.ix_(rows, cols)].astype(np.float64).sum())
    np.testing.assert_allclose(float(got[0, 0, 0]), total, rtol=1e-6)
    with pytest.raises(ValueError):
        acquire.acquire(*(torch.as_tensor(a) for a in (img, oy[:6], ox[:6], rxy)))
    with pytest.raises(ValueError):
        acquire.acquire(*(torch.as_tensor(a) for a in (img, oy, ox, rxy[:8])), roll=True)


@pytest.mark.parametrize("probe", probes.PROBES, ids=lambda p: p.name)
def test_probe_plain_passes_its_check(probe):
    args = probe.inputs(torch.device("cpu"))
    before = probe.kernel.launches
    out = probe.fn(*args)
    assert probe.kernel.launches == before               # CPU tensors: plain version
    assert torch.equal(out, probe.plain(*args))
    ok, err = probe.judge(out.numpy(), args)
    assert ok, (probe.name, err)


def test_probes_assert_what_the_tpu_probes_assert():
    o = {p.name: p.fn(*p.inputs(torch.device("cpu"))).numpy() for p in probes.PROBES}
    np.testing.assert_array_equal(o["unaligned_sublane_slice"],
                                  np.arange(64 * 128, dtype=np.float32).reshape(64, 128)[3:11])
    assert o["lane_lane_dot"].shape == (16, 16) and o["lane_lane_dot"].dtype == np.float32
    assert o["f32_scalar_prefetch"][0, 0] == 3.5
    assert o["transpose_2d"].shape == (256, 16)
    b = o["concat_blockdiag"]
    assert b[0, 0] == 1 and b[50, 70] == 2 and b[0, 70] == 0 and b[50, 0] == 0
    s = o["sublane_interleave_write"]
    assert s[3, 0] == 1 and s[11, 0] == 1 and s[4, 0] == 0
    np.testing.assert_array_equal(
        o["dyn_roll_cost_shape"],
        np.roll(np.arange(48 * 256, dtype=np.float32).reshape(48, 256), 5, axis=1))
    assert o["f32_small_dot"].shape == (16, 128)
    results = probes.run_probes("cpu")
    assert set(results) == {p.name for p in probes.PROBES}
    assert all(ok for ok, _ in results.values()), results


@pytest.mark.parametrize("k", [256, 272, 528])
def test_lane_lane_dot_fragment_slots_pair_equal_k(k):
    """``lane_lane_dot`` in csrc/probes.cu fills lane (g, q)'s m16n8k16 slots
    2q, 2q + 1, 2q + 8, 2q + 9 of rows g, g + 8 of a and of row g of b's
    n-tile from 16-byte words: elements 8q .. 8q + 3 of each 32-wide chunk of
    k for one mma step, 8q + 4 .. 8q + 7 for the next, and 4q .. 4q + 3 of a
    16-wide tail. Chunk ch goes to warp ch % 8 of the n-tile's block, the
    tail to warp (k // 32) % 8, and the warps' partial tiles are summed in
    warp order. Emulated here step by step, the result is a . b^T: every k
    is paired with itself once, by one warp."""
    rng = np.random.default_rng(k)
    n, warps = 16, 8
    a = rng.standard_normal((16, k))
    b = rng.standard_normal((n, k))
    chunks = k // 32
    steps = [(ch % warps, lambda q, e, c0=ch * 32, half=half: c0 + 8 * q + 4 * half + e)
             for ch in range(chunks) for half in (0, 1)]
    if k % 32:
        steps.append((chunks % warps, lambda q, e: k - 16 + 4 * q + e))
    out = np.zeros((16, n))
    for nt in range(n // 8):
        part = np.zeros((warps, 16, 8))
        for warp, phys in steps:
            frag_a, frag_b = np.zeros((16, 16)), np.zeros((16, 8))
            for g in range(8):
                for q in range(4):
                    for e, slot in enumerate((2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9)):
                        frag_a[g, slot] = a[g, phys(q, e)]
                        frag_a[g + 8, slot] = a[g + 8, phys(q, e)]
                        frag_b[slot, g] = b[nt * 8 + g, phys(q, e)]
            part[warp] += frag_a @ frag_b
        out[:, nt * 8:nt * 8 + 8] = part.sum(axis=0)
    np.testing.assert_allclose(out, a @ b.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_ld_words_reads_any_base_in_aligned_words(phase):
    """``ld_words`` in csrc/probes.cu: the words p[0] .. p[valid - 1] of an
    array on 4 bytes. It loads the aligned 16-byte word that holds p[0]
    when valid > 0 and the next one when phase + valid passes 4, then takes
    words phase .. phase + 3 of the pair by a shift of two words (phase &
    2) and one of one word (phase & 1); lanes at or past valid are 0.
    Emulated here on a memory of 32-bit words: every base and count reads
    exactly the words asked for, and no word past the one holding the last."""
    mem = np.arange(1, 65, dtype=np.uint32)           # word 0 starts on 16 bytes
    for start in range(phase, 48, 4):
        for valid in (0, 1, 2, 3, 4):
            w = start & ~3
            loads = [w] * (valid > 0) + [w + 4] * (phase + valid > 4)
            lo = mem[w:w + 4] if valid > 0 else np.zeros(4, np.uint32)
            hi = mem[w + 4:w + 8] if phase + valid > 4 else np.zeros(4, np.uint32)
            two, one = phase & 2, phase & 1
            s = [lo[2] if two else lo[0], lo[3] if two else lo[1], hi[0] if two else lo[2],
                 hi[1] if two else lo[3], hi[2] if two else hi[0]]
            lanes = [int(s[i + 1] if one else s[i]) if i < valid else 0 for i in range(4)]
            assert lanes == list(mem[start:start + valid]) + [0] * (4 - valid)
            if valid:
                assert max(loads) <= start + valid - 1 < max(loads) + 4
            else:
                assert not loads
