"""The frames and draws a run makes are the seed's: the same seed gives the
same, another seed other ones, and every view keeps to its mix's limits."""

import math

import numpy as np
import pytest
import torch

from siftbench import views
from siftbench.program import Reference
from siftbench.registry import Registry

CPU = torch.device("cpu")
H, W = 90, 120


def mix(name):
    return Registry().traffic(name)["views"]


@pytest.mark.parametrize("name", ["frames", "pairs", "track"])
def test_same_seed_same_views(name):
    a = views.Views(mix(name), H, W, 2**31 + 11, CPU)
    b = views.Views(mix(name), H, W, 2**31 + 11, CPU)
    c = views.Views(mix(name), H, W, 12, CPU)
    assert torch.equal(a.frames, b.frames)
    assert not torch.equal(a.frames, c.frames)
    assert a.frames.shape == (mix(name)["count"] * (2 if name == "pairs" else 1), H, W)
    assert float(a.frames.min()) >= 0.0 and float(a.frames.max()) <= 255.0
    if name == "pairs":
        assert all(np.array_equal(x, y) for x, y in zip(a.truths, b.truths))


def test_path_steps_keep_to_the_limits():
    spec = mix("frames")
    maps = views.path_maps(spec, 1080, 1920, 2160, 3840, 5)
    assert len(maps) == spec["count"]
    for m0, m1 in zip(maps, maps[1:] + maps[:1]):      # the path is a loop
        step = np.linalg.inv(m0) @ m1
        a = step[:2, :2]
        scale = math.sqrt(abs(np.linalg.det(a)))
        rot = math.degrees(math.atan2(a[1, 0], a[0, 0]))
        assert abs(rot) <= spec["max_rot_deg"] + 1e-9
        lo, hi = spec["scale_range"]
        assert lo - 1e-9 <= scale <= hi + 1e-9
        centre = np.array([(1920 - 1) / 2, (1080 - 1) / 2, 1.0])
        moved = m1 @ centre - m0 @ centre
        assert math.hypot(moved[0], moved[1]) <= spec["max_shift_px"] * 1.1 + 1e-9
        for m in (m0, m1):
            c = views.corners(m, 1080, 1920)
            assert c.min() >= 0 and c[:, 0].max() <= 3839 and c[:, 1].max() <= 2159


def test_pairs_keep_to_the_limits():
    spec = mix("pairs")
    maps_a, maps_b, truths = views.pair_maps(spec, 1080, 1920, 2160, 3840, 6)
    for ma, mb, g in zip(maps_a, maps_b, truths):
        np.testing.assert_allclose(ma @ np.linalg.inv(g), mb)
        a = g[:2, :2]
        assert abs(math.degrees(math.atan2(a[1, 0], a[0, 0]))) <= spec["max_rot_deg"] + 1e-9
        assert np.abs(g[2, :2] * [1920, 1080]).max() <= spec["max_persp"] + 1e-12
        for m in (ma, mb):
            c = views.corners(m, 1080, 1920)
            assert c.min() >= 0 and c[:, 0].max() <= 3839 and c[:, 1].max() <= 2159


def test_draws_are_the_seeds():
    cfg = Registry().config("cudasift-1920x1080")
    ref = Reference(cfg, CPU)
    a, b = ref.draws(views.derive(7, "draws", 3)), ref.draws(views.derive(7, "draws", 3))
    assert a.shape == (cfg["find_homography"]["num_loops"], 4) and torch.equal(a, b)
    assert not torch.equal(a, ref.draws(views.derive(7, "draws", 4)))
    assert views.derive(2**31 + 5, "canvas") != views.derive(2**31 + 6, "canvas")
