"""The 2x-upscale configuration (``cudasift-1280x960-upscale``) at a small
size on the CPU: the measured program's extraction with ``scale_up`` against
its own plain reference (``reference/sift_upscale.py``), held to the
``960p-upscale`` cell's limits, with a ``lowest_scale`` that only the
doubling moves; the reference at ``scale_up=False`` is
``reference/sift.py``'s, bit for bit; its upsample against a loop over the
pixels."""

import dataclasses

import numpy as np
import pytest
import torch

from siftbench import compare, views
from siftbench.program import Port, Reference
from siftbench.reference import sift, sift_upscale
from siftbench.registry import Registry

CPU = torch.device("cpu")
H, W = 192, 256


@pytest.fixture(scope="module")
def frames():
    return views.Views(Registry().traffic("frames")["views"], H, W, 2**31 + 11, CPU).frames


def small_config(**sift_kw) -> dict:
    cfg = Registry().config("cudasift-1280x960-upscale")
    return dict(cfg, frame={"height": H, "width": W},
                sift=dict(cfg["sift"], num_octaves=3, thresh=2.0, max_pts=2048, **sift_kw))


def fields_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("lowest_scale", [0.0, 0.8])
def test_port_with_upscale_is_within_the_cells_limits(frames, lowest_scale):
    cfg = small_config(lowest_scale=lowest_scale)
    assert cfg["reference"] == "sift_upscale" and cfg["sift"]["scale_up"]
    limits = Registry().limits("960p-upscale")["check"]
    port, ref = Port(cfg, CPU), Reference(cfg, CPU)
    assert ref.extraction is sift_upscale
    for frame in frames[:2]:
        got, want = port.extract(frame), ref.extract(frame)
        assert int(want.num_pts) > 100
        numbers = {f"extract.{k}": v for k, v in compare.points(got, want).items()}
        assert all(numbers[k] <= lim for k, lim in limits.items()), numbers
        # The plain path and the reference share every operation's order.
        assert fields_equal(got, want)
        # Positions are the frame's, not the upsampled frame's.
        n = int(want.num_pts)
        assert float(want.xpos[:n].max()) < W and float(want.ypos[:n].max()) < H


def test_lowest_scale_is_doubled(frames):
    """At lowest_scale 0.8 the doubled 1.6 drops points of the upsampled
    octave 0 that 0.8 keeps: the port and the reference agree with the
    doubling and not without it."""
    cfg = small_config(lowest_scale=0.8)
    got = Port(cfg, CPU).extract(frames[0])
    undoubled = sift.extract(sift_upscale.upsample(frames[0]),
                             sift_upscale.SiftConfig.from_dict(cfg["sift"]))
    uncut = Reference(small_config(), CPU).extract(frames[0])
    assert int(got.num_pts) < int(undoubled.num_pts) == int(uncut.num_pts)
    assert int(got.num_pts) == int(Reference(cfg, CPU).extract(frames[0]).num_pts)


def test_without_upscale_the_reference_is_the_package_sift(frames):
    d = small_config(scale_up=False)["sift"]
    cfg = sift_upscale.SiftConfig.from_dict(d)
    assert not cfg.scale_up
    got = sift_upscale.extract(frames[2], cfg)
    want = sift.extract(frames[2], sift.SiftConfig.from_dict(d))
    assert int(want.num_pts) > 30 and fields_equal(got, want)


def test_the_reference_refuses_what_it_has_no_path_for():
    with pytest.raises(NotImplementedError, match="grad_mode"):
        sift_upscale.SiftConfig.from_dict(small_config(grad_mode="fast")["sift"])
    with pytest.raises(NotImplementedError, match="scale_up"):
        sift.SiftConfig.from_dict(small_config()["sift"])


@pytest.mark.parametrize("h,w", [(1, 1), (1, 5), (4, 1), (5, 7), (6, 8), (31, 33)])
def test_upsample_against_a_loop_over_the_pixels(h, w):
    img = np.random.default_rng(h * 100 + w).standard_normal((h, w)).astype(np.float32)
    want = np.empty((2 * h, 2 * w), np.float32)
    f = np.float32
    for y in range(h):
        for x in range(w):
            a, r = img[y, x], img[y, min(x + 1, w - 1)]
            d, dr = img[min(y + 1, h - 1), x], img[min(y + 1, h - 1), min(x + 1, w - 1)]
            want[2 * y, 2 * x] = a
            want[2 * y, 2 * x + 1] = f(0.5) * (a + r)
            want[2 * y + 1, 2 * x] = f(0.5) * (a + d)
            want[2 * y + 1, 2 * x + 1] = f(0.25) * (((a + r) + d) + dr)
    got = sift_upscale.upsample(torch.as_tensor(img)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
