"""The PyTorch port's configuration, SiftData and conversion helpers against
the JAX package, and the port's independence from jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cudasift_tpu as cs
from cudasift_tpu import config as jcfg
from cudasift_tpu import sift_data as jsd

import cudasift_tpu_torch as ct
from cudasift_tpu_torch import config as tcfg
from cudasift_tpu_torch.convert import (params_from_jax, sift_data_from_numpy,
                                        sift_data_to_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("num_octaves,init_blur", [(1, 0.0), (5, 0.0), (7, 0.5)])
def test_laplace_kernels_equal(num_octaves, init_blur):
    np.testing.assert_array_equal(tcfg.laplace_kernels(num_octaves, init_blur),
                                  jcfg.laplace_kernels(num_octaves, init_blur))
    np.testing.assert_array_equal(tcfg.gaussian_kernel_1d(4, 1.3),
                                  jcfg.gaussian_kernel_1d(4, 1.3))


@pytest.mark.parametrize("height,width", [(1080, 1920), (960, 1280), (192, 256), (67, 120)])
def test_capacity_and_octave_shapes_equal(height, width):
    for kw in ({}, {"max_pts": 2048, "min_candidates": 128, "scale_up": True}):
        tp, jp = tcfg.SiftParams(num_octaves=7, **kw), jcfg.SiftParams(num_octaves=7, **kw)
        assert tp.octave_shapes(height, width) == jp.octave_shapes(height, width)
        for o, (oh, ow) in enumerate(tp.octave_shapes(height, width)):
            assert tp.candidate_capacity(oh, ow, o) == jp.candidate_capacity(oh, ow, o)
        assert tp.lowest_scale_effective == jp.lowest_scale_effective
        np.testing.assert_array_equal(tp.laplace_kernels, jp.laplace_kernels)


@pytest.mark.parametrize("jax_params", [
    jcfg.SiftParams(thresh=2.5, grad_mode="exact", max_pts=4096),
    jcfg.HomographyParams(num_loops=77, thresh=4.0),
    jcfg.MatchParams(use_bf16=True, tile_n2=512),
])
def test_params_from_jax(jax_params):
    ported = params_from_jax(jax_params)
    assert type(ported).__name__ == type(jax_params).__name__
    assert dataclasses.asdict(ported) == dataclasses.asdict(jax_params)


def test_params_from_jax_rejects_other_objects():
    with pytest.raises(TypeError):
        params_from_jax(object())


def test_sift_data_fields_and_round_trip():
    jfields = [f.name for f in dataclasses.fields(jsd.SiftData)]
    assert [f.name for f in dataclasses.fields(ct.SiftData)] == jfields
    jdata = jsd.init_sift_data(64)
    arrays = {name: np.asarray(getattr(jdata, name)) for name in jfields}
    tdata = sift_data_from_numpy(arrays)
    back = sift_data_to_numpy(tdata)
    init = sift_data_to_numpy(ct.init_sift_data(64))
    for name in jfields:
        np.testing.assert_array_equal(back[name], arrays[name])
        np.testing.assert_array_equal(init[name], arrays[name])
        assert back[name].dtype == arrays[name].dtype, name
    assert tdata.max_pts == 64
    assert not tdata.valid_mask().any()


def test_print_and_ref_style_num_pts_match_jax(capsys):
    rng = np.random.default_rng(0)
    n, cap = 6, 16
    arrays = {f.name: np.asarray(getattr(jsd.init_sift_data(cap), f.name))
              for f in dataclasses.fields(jsd.SiftData)}
    arrays["num_pts"] = np.int32(n)
    xs = rng.uniform(0, 100, 4).astype(np.float32)
    # Four primaries, then duplicates of the last two (a trailing dup block).
    for name, vals in (("xpos", xs), ("ypos", xs + 1), ("scale", xs / 50)):
        col = np.zeros(cap, np.float32)
        col[:4] = vals
        col[4:6] = vals[2:4]
        arrays[name] = col
    arrays["data"] = rng.uniform(0, 0.3, (cap, 128)).astype(np.float32)
    jdata = jsd.SiftData(**{k: np.asarray(v) for k, v in arrays.items()})
    tdata = sift_data_from_numpy(arrays)
    assert ct.ref_style_num_pts(tdata) == cs.ref_style_num_pts(jdata) == 4
    cs.print_sift_data(jdata)
    jout = capsys.readouterr().out
    ct.print_sift_data(tdata)
    assert capsys.readouterr().out == jout


def test_package_never_imports_jax():
    code = ("import sys, cudasift_tpu_torch, cudasift_tpu_torch.ops.cuda, "
            "cudasift_tpu_torch.convert, cudasift_tpu_torch.utils.synth, "
            "cudasift_tpu_torch.utils.timers, cudasift_tpu_torch.utils.build; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
