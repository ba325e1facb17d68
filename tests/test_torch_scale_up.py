"""The ScaleUp kernel's wrapper and its place in the pipeline, without a
card: the kernel stands apart from the ports of TPU kernels; a restatement
of its thread layout (two input pixels a thread, 16- or 8-byte stores) in
numpy writes every output entry once and equals the plain twin,
``convolve.scale_up``, bit for bit; CPU tensors take the twin; an
extraction with ``scale_up`` goes through the wrapper once inside its own
``extract.upscale`` stage, and one without it opens no such stage."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cudasift_tpu_torch as ct
from cudasift_tpu_torch import pipeline
from cudasift_tpu_torch.ops import convolve
from cudasift_tpu_torch.ops import cuda
from cudasift_tpu_torch.ops.cuda import scale_up
from cudasift_tpu_torch.utils import trace
from cudasift_tpu_torch.utils.build import Kernel
from cudasift_tpu_torch.utils.synth import make_test_image

SHAPES = [(1, 1), (1, 6), (2, 1), (5, 7), (6, 8), (31, 33), (96, 128)]


def test_the_kernel_stands_apart_from_the_tpu_ports():
    assert scale_up.KERNEL in Kernel.instances
    for group in (cuda.LIBRARY, cuda.KERNELS, cuda.FUSED_PATH, cuda.SPLIT_PATH):
        assert scale_up.KERNEL not in group
    assert scale_up.KERNEL.name == "scale_up" and "-fmad=false" in scale_up.KERNEL.flags
    assert "scale_up" in trace.snapshot()["launches"]
    # The wrapper's height limit is the kernel's grid: rows a block times
    # CUDA's grid y.
    src = (Path(scale_up.__file__).resolve().parents[2] / "csrc" / "scale_up.cu").read_text()
    rows = int(re.search(r"constexpr int ROWS = (\d+);", src).group(1))
    grid_y = int(re.search(r"constexpr int MAX_GRID_Y = (\d+);", src).group(1))
    assert scale_up.MAX_HEIGHT == rows * grid_y


def kernel_layout(img: np.ndarray, even: bool) -> np.ndarray:
    """``csrc/scale_up.cu`` restated: thread (pair k, row y) reads its two
    pixels, their right neighbour and the same of the row below, and writes
    its 2x4 block at the kernel's flat offsets, as one 4-wide store a row
    (``even``) or 2-wide stores. Entries no thread writes stay NaN."""
    h, w = img.shape
    f = np.float32
    flat = np.full(4 * h * w, np.nan, np.float32)
    written = np.zeros(4 * h * w, np.int64)

    def store(at, values):
        flat[at:at + len(values)] = values
        written[at:at + len(values)] += 1

    for y in range(h):
        yd = min(y + 1, h - 1)
        for k in range((w + 1) // 2):
            x0 = 2 * k
            x1, x2 = min(x0 + 1, w - 1), min(x0 + 2, w - 1)
            a0, a1, a2 = img[y, x0], img[y, x1], img[y, x2]
            d0, d1, d2 = img[yd, x0], img[yd, x1], img[yd, x2]
            top = 2 * y * 2 * w + 2 * x0
            bot = top + 2 * w
            t = [a0, f(0.5) * (a0 + a1), a1, f(0.5) * (a1 + a2)]
            b = [f(0.5) * (a0 + d0), f(0.25) * (((a0 + a1) + d0) + d1),
                 f(0.5) * (a1 + d1), f(0.25) * (((a1 + a2) + d1) + d2)]
            if even:
                assert top % 4 == 0 and bot % 4 == 0      # 16-byte stores
                store(top, t)
                store(bot, b)
            else:
                assert top % 2 == 0 and bot % 2 == 0      # 8-byte stores
                store(top, t[:2])
                store(bot, b[:2])
                if x0 + 1 < w:
                    store(top + 2, t[2:])
                    store(bot + 2, b[2:])
    assert (written == 1).all()
    return flat.reshape(2 * h, 2 * w)


@pytest.mark.parametrize("h,w", SHAPES)
def test_the_kernels_layout_equals_the_plain_twin(h, w):
    img = make_test_image(max(h, 8), max(w, 8), seed=h * 31 + w)[:h, :w].copy()
    twin = convolve.scale_up(torch.as_tensor(img)).numpy()
    for even in ((False, True) if w % 2 == 0 else (False,)):
        got = kernel_layout(img, even)
        assert np.array_equal(got, twin), (h, w, even)


@pytest.mark.parametrize("h,w", SHAPES)
def test_cpu_tensors_take_the_twin(h, w):
    img = torch.as_tensor(make_test_image(max(h, 8), max(w, 8), seed=7)[:h, :w].copy())
    before = scale_up.KERNEL.launches
    got = scale_up.scale_up(img)
    assert got.shape == (2 * h, 2 * w) and torch.equal(got, convolve.scale_up(img))
    assert scale_up.KERNEL.launches == before
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        scale_up.scale_up(img[None])


@pytest.fixture
def tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.mark.parametrize("up", [True, False])
def test_the_pipeline_upsamples_through_the_wrapper_in_its_stage(monkeypatch, tracing_off, up):
    calls = []

    def counted(img):
        calls.append(tuple(img.shape))
        return convolve.scale_up(img)

    monkeypatch.setattr(cuda.scale_up, "scale_up", counted)
    params = ct.SiftParams(num_octaves=2, thresh=2.0, max_pts=512, scale_up=up)
    img = make_test_image(48, 64, seed=23)
    trace.enable()
    out = ct.extract_sift(img, params, device="cpu")
    stages = trace.snapshot()["stages"]
    assert int(out.num_pts) > 0
    if up:
        assert calls == [(48, 64)]
        assert stages["extract.upscale"]["count"] == stages["extract.pyramid"]["count"] == 1
        pyramid = stages["extract.pyramid"]
        assert pyramid["self_ms"] == pytest.approx(
            pyramid["ms"] - stages["extract.upscale"]["ms"], rel=1e-9, abs=1e-9)
    else:
        assert calls == [] and "extract.upscale" not in stages
        assert stages["extract.pyramid"]["self_ms"] == pytest.approx(
            stages["extract.pyramid"]["ms"])


def test_upscaled_extraction_reads_in_frame_coordinates():
    img = make_test_image(48, 64, seed=24)
    d = pipeline.extract_sift(img, ct.SiftParams(num_octaves=2, thresh=2.0, max_pts=512,
                                                 scale_up=True), device="cpu")
    n = int(d.num_pts)
    assert n > 0 and float(d.xpos[:n].max()) < 64 and float(d.ypos[:n].max()) < 48
