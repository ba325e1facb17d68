"""The plain reference agrees with the measured program's plain CPU path at
a small size, stage by stage, and its control precision rounds as TF32."""

import dataclasses

import numpy as np
import pytest
import torch

from cudasift_tpu_torch.ops.match import split_tf32
from siftbench import views
from siftbench.program import Port, Reference
from siftbench.reference.precision import tf32_round
from siftbench.registry import Registry

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small():
    cfg = Registry().config("cudasift-1920x1080")
    cfg = dict(cfg, frame={"height": 120, "width": 160},
               sift=dict(cfg["sift"], num_octaves=3, max_pts=2048),
               find_homography=dict(cfg["find_homography"], num_loops=256))
    frames = views.Views(Registry().traffic("frames")["views"], 120, 160, 2**31 + 3, CPU).frames
    return cfg, frames


def fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y), f.name


def test_reference_equals_the_plain_path(small):
    cfg, frames = small
    port, ref = Port(cfg, CPU), Reference(cfg, CPU)
    pa, pb = port.extract(frames[0]), port.extract(frames[1])
    ra, rb = ref.extract(frames[0]), ref.extract(frames[1])
    assert int(pa.num_pts) > 30
    fields_equal(pa, ra)
    fields_equal(pb, rb)
    pm, rm = port.match(pa, pb), ref.match(pa, pb)
    fields_equal(pm, rm)
    seed = views.derive(1, "draws", 0)
    ph, rh = port.find_homography(pm, seed), ref.find_homography(pm, seed)
    assert torch.equal(ph[0], rh[0]) and int(ph[1]) == int(rh[1]) > 8
    pi, ri = port.improve_homography(pm, ph[0]), ref.improve_homography(pm, ph[0])
    assert all(torch.equal(x, y) for x, y in zip(pi, ri))


def test_reference_refuses_settings_it_has_no_path_for(small):
    cfg, _ = small
    with pytest.raises(NotImplementedError):
        Reference(dict(cfg, sift=dict(cfg["sift"], grad_mode="fast")), CPU)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1000.4, -1000.6, 255.03])
    got = tf32_round(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1000.5, -1000.5, 255.0]
    # The matcher's own TF32 split rounds the same way (cvt.rna).
    assert torch.equal(got, split_tf32(x)[0])
    assert np.all(np.abs(got.numpy() - x.numpy()) <= np.abs(x.numpy()) * 2**-11)
