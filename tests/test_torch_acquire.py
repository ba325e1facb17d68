"""The window-to-box decomposition of the patch-acquisition kernels (P1,
``csrc/acquire.cu``) restated in numpy: ``acquire.window_boxes`` against the
plain version (the boxes' sums are the window's), the bench's inputs as one
TMA box a keypoint, and the direct kernel's aligned 16-byte words."""

import numpy as np
import pytest
import torch

from cudasift_tpu_torch.ops.cuda import acquire


def window_sums(img, oy, ox, rxy, roll):
    """Each keypoint's window sum through the plain version's indices (float64)."""
    h, w = img.shape
    rows, cols = acquire.window_index(*(torch.as_tensor(a) for a in (oy, ox, rxy)), roll, h, w)
    return img.astype(np.float64)[rows.numpy(), cols.numpy()].sum(axis=(1, 2))


def box_sums(img, boxes):
    """Each keypoint's sum over its boxes, every read clamped to the image."""
    h, w = img.shape
    out = []
    for kp in boxes:
        total = 0.0
        for b in kp:
            r = np.clip(np.arange(b.y, b.y + b.rows), 0, h - 1)
            c = np.clip(np.arange(b.x, b.x + b.cols), 0, w - 1)
            total += img.astype(np.float64)[np.ix_(r, c)].sum()
        out.append(total)
    return np.array(out)


def wrap_clamp_inputs(seed, h, w, n=64):
    """Origins anywhere from before the image to past it, realignments over
    the whole of the patch (rows up to 55, columns up to 255)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w)).astype(np.float32)
    oy = rng.integers(-60, h + 8, n).astype(np.int32)
    ox = rng.integers(-260, w + 8, n).astype(np.int32)
    rxy = np.concatenate([rng.integers(0, 56, n), rng.integers(0, 256, n)]).astype(np.int32)
    return img, oy, ox, rxy


@pytest.mark.parametrize("h,w,roll", [(130, 420, True), (97, 301, True), (200, 520, False),
                                      (75, 259, False)])
def test_window_boxes_sum_to_the_window(h, w, roll):
    img, oy, ox, rxy = wrap_clamp_inputs(h * w, h, w)
    boxes = acquire.window_boxes(oy, ox, rxy, roll, h, w)
    np.testing.assert_allclose(box_sums(img, boxes), window_sums(img, oy, ox, rxy, roll),
                               rtol=1e-9, atol=1e-9)
    # The plain version, which the kernels are held to, sums the same groups.
    got = acquire.acquire_plain(*(torch.as_tensor(a) for a in (img, oy, ox, rxy)), roll)
    groups = box_sums(img, boxes).reshape(-1, acquire.GROUP).sum(axis=1)
    np.testing.assert_allclose(got[:, 0, 0].numpy(), groups, rtol=1e-4, atol=1e-3)
    counts = [len(kp) for kp in boxes]
    assert all(1 <= c <= 4 for c in counts) and (max(counts) == 4 if roll else max(counts) == 1)
    for kp in boxes:
        assert sum(b.rows * b.cols for b in kp) == acquire.P * acquire.PW
        for b in kp:
            inside = b.y >= 0 and b.y + b.rows <= h and b.x >= 0 and b.x + b.cols <= w
            assert b.tma == (inside and w % 4 == 0)


@pytest.mark.parametrize("roll", [False, True])
def test_bench_inputs_are_one_tma_box_each(roll):
    img, oy, ox, rxy = acquire.bench_inputs(2048, 1080, 1920, seed=0)
    boxes = acquire.window_boxes(oy, ox, rxy, roll, *img.shape)
    assert all(len(kp) == 1 and kp[0].tma for kp in boxes)
    assert all((kp[0].rows, kp[0].cols) == (acquire.P, acquire.PW) for kp in boxes)
    tensors = tuple(torch.as_tensor(a) for a in (oy, ox, rxy))
    assert acquire.window_boxes(*tensors, roll, *img.shape) == boxes


def test_window_boxes_need_an_image_tma_can_address():
    img, oy, ox, rxy = acquire.bench_inputs(64, 72, 640, seed=1)
    h, w = img.shape
    assert all(b.tma for kp in acquire.window_boxes(oy, ox, rxy, True, h, w) for b in kp)
    for args, kw in (((h, w - 1), {}), ((h, w), {"base_aligned": False}),
                     ((h, 60), {}), ((40, w), {})):
        boxes = acquire.window_boxes(oy, ox, rxy, True, *args, **kw)
        assert not any(b.tma for kp in boxes for b in kp)


@pytest.mark.parametrize("misalign", [0, 4, 8, 12])
def test_direct_words_cover_each_row_once(misalign):
    """``sum_words`` in csrc/acquire.cu: row r of a piece starts at byte
    address a; slot j of the row reads the 16-byte word at (a & ~15) + 16 j
    when it starts before a + 4 cols, and keeps its elements lo <= e < hi,
    lo = (a & 15) / 4 - 4 j, hi = lo + cols. Every element of the row is
    kept exactly once, by WORDS = 17 slots at most."""
    rng = np.random.default_rng(misalign)
    w = 301
    for _ in range(200):
        x = int(rng.integers(0, w - 64))
        cols = int(rng.integers(1, 65))
        y = int(rng.integers(0, 50))
        a = 4096 + misalign + 4 * (y * w + x)          # byte address of the row's first element
        kept = []
        for j in range(17):
            word = (a & ~15) + 16 * j
            if word >= a + 4 * cols:
                continue
            lo = (a & 15) // 4 - 4 * j
            kept += [(word + 4 * e - a) // 4 for e in range(4) if lo <= e < lo + cols]
        assert sorted(kept) == list(range(cols))


def test_windows_wrapped_inside_the_image_take_four_rounds_of_slots():
    """Realignments ry > 8 and rx > 192 cut every window into four pieces,
    all inside the image when the aligned patch is: 32 TMA boxes for a group
    of 8 keypoints, so the staged kernel (eight slots a block) issues them in
    four rounds, refilling each slot after its last box is summed. The
    boxes' sums are still the window's."""
    h, w, n = 130, 420, 32
    rng = np.random.default_rng(69)
    img = rng.random((h, w), dtype=np.float32)
    oy = rng.integers(0, h - acquire.PR + 1, n).astype(np.int32)
    ox = rng.integers(0, w - acquire.PWR + 1, n).astype(np.int32)
    rxy = np.concatenate([rng.integers(9, 56, n), rng.integers(193, 256, n)]).astype(np.int32)
    boxes = acquire.window_boxes(oy, ox, rxy, True, h, w)
    slots = 8
    for g in range(n // acquire.GROUP):
        group = boxes[g * acquire.GROUP:(g + 1) * acquire.GROUP]
        tma = sum(b.tma for kp in group for b in kp)
        assert tma == 4 * acquire.GROUP and -(-tma // slots) == 4
    np.testing.assert_allclose(box_sums(img, boxes), window_sums(img, oy, ox, rxy, True),
                               rtol=1e-9, atol=1e-9)
    unrolled = acquire.window_boxes(oy, ox, rxy, False, h, w)
    assert all(len(kp) == 1 and kp[0].tma for kp in unrolled)
