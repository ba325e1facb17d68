"""The CUDA kernels (K1-K8 with K3's three samplers, the patch-acquisition
kernels P1 and the probes P2) against their plain versions on the card, the
pipeline, fused and split, on the card against the CPU, and the demo CLI on
the card. Marked ``gpu``: they skip without a CUDA device. On the card run
them with ``python -m pytest tests/test_torch_gpu.py -q --noconftest``: the
conftest only configures jax, which these tests do not use."""

import json

import numpy as np
import pytest
import torch

import cudasift_tpu_torch as ct
from cudasift_tpu_torch import cli
from cudasift_tpu_torch.config import laplace_kernels
from cudasift_tpu_torch.ops import convolve, detect
from cudasift_tpu_torch.ops import match as match_plain
from cudasift_tpu_torch.ops.cuda import (FUSED_PATH, acquire, compact, descriptor, dog, match,
                                         orient, orient_desc, probes, refine)
from cudasift_tpu_torch.utils import io, synth
from cudasift_tpu_torch.utils.synth import make_test_image

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def octave(cuda, h=200, w=300):
    return convolve.low_pass(torch.as_tensor(make_test_image(h, w, seed=51), device=cuda), 1.0)


def test_dog_kernel_matches_plain(cuda):
    img = octave(cuda)
    taps = laplace_kernels(1)[0]
    before = dog.KERNEL.launches
    got = dog.dog_and_mask(img, taps, 2.0, 10.0)
    ref = dog.dog_and_mask_plain(img, taps, 2.0, 10.0)
    torch.cuda.synchronize()
    assert dog.KERNEL.launches == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_refine_kernel_matches_plain(cuda):
    img = octave(cuda)
    d, m = dog.dog_and_mask(img, laplace_kernels(1)[0], 2.0, 10.0)
    idx, cnt = detect.compact_mask(m, 512)
    got = refine.refine_candidates(d, idx, cnt, 10.0, 0.0)
    ref = detect.refine_candidates(d, idx, cnt, 10.0, 0.0)
    assert int(cnt) > 10 and torch.equal(got.valid, ref.valid)
    for name in ("xpos", "ypos", "scale", "sharpness", "edgeness"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=3e-7, atol=0)


@pytest.mark.parametrize("mode", ["shift", "exact", "fast"])
def test_orient_desc_kernel_matches_plain(cuda, mode):
    img = octave(cuda)
    rng = np.random.default_rng(52)
    n = 64
    x = torch.tensor(rng.uniform(-1, 300, n), dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.uniform(-1, 200, n), dtype=torch.float32, device=cuda)
    s = torch.tensor(rng.uniform(0.9, 2.4, n), dtype=torch.float32, device=cuda)
    live = torch.arange(n, device=cuda) % 7 != 0
    got = orient_desc.orient_and_describe(img, x, y, s, live, mode)
    ref = orient_desc.orient_and_describe_plain(img, x, y, s, live, mode)
    dori = (got[2] - ref[2]).abs()
    assert float(dori.median()) < 0.2 and float((dori < 2.0).float().mean()) >= 0.9
    same = live & (dori < 1e-3)
    assert int(same.sum()) >= 0.9 * int(live.sum())
    assert float((got[0] - ref[0]).abs()[same].max()) < 2e-2
    assert not got[0][~live].any() and not got[4][~live].any()
    again = orient_desc.orient_and_describe(img, x, y, s, live, mode)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("use_bf16", [False, True])
def test_match_kernel_matches_plain(cuda, use_bf16):
    g = torch.Generator(device=cuda).manual_seed(53)
    d1 = torch.nn.functional.normalize(torch.randn(700, 128, device=cuda, generator=g), dim=1)
    d2 = torch.nn.functional.normalize(torch.randn(900, 128, device=cuda, generator=g), dim=1)
    d2[[11, 40]] = d1[3]                          # a tie: lowest index wins
    for n1, n2 in ((700, 900), (650, 601), (700, 0)):
        got = match.match_descriptors(d1, d2, n1, n2, use_bf16=use_bf16)
        ref = match_plain.match_descriptors(d1, d2, n1, n2, use_bf16=use_bf16)
        assert torch.equal(got[2], ref[2])
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-5)
    assert int(match.match_descriptors(d1, d2, 700, 900)[2][3]) == 11


def test_pipeline_on_card_matches_cpu(cuda):
    img = make_test_image(192, 256, seed=54)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    on_gpu = ct.extract_sift(torch.as_tensor(img, device=cuda), params)
    again = ct.extract_sift(torch.as_tensor(img, device=cuda), params)
    on_cpu = ct.extract_sift(img, params, device="cpu")
    n = int(on_cpu.num_pts)
    assert int(on_gpu.num_pts) == n and n > 30
    torch.testing.assert_close(on_gpu.xpos.cpu(), on_cpu.xpos, rtol=1e-5, atol=1e-4)
    assert torch.equal(on_gpu.data, again.data)
    with pytest.raises(NotImplementedError):
        ct.extract_sift(torch.as_tensor(img, device=cuda), ct.SiftParams(use_pallas=False))


def test_compact_kernel_matches_plain(cuda):
    _, m = dog.dog_and_mask(octave(cuda), laplace_kernels(1)[0], 2.0, 10.0)
    g = torch.Generator(device=cuda).manual_seed(55)
    dense = torch.rand((5, 67, 251), device=cuda, generator=g) < 0.3
    for mask, cap in ((m, 512), (m, 8), (dense, 4096), (dense, 70000),
                      (torch.zeros((5, 9, 9), dtype=torch.bool, device=cuda), 128)):
        before = compact.KERNEL.launches
        got = compact.compact_mask(mask, cap)
        ref = detect.compact_mask(mask, cap, with_total=True)
        assert compact.KERNEL.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


def front_packed(cuda, n=64, live=50):
    img = octave(cuda)
    rng = np.random.default_rng(56)
    # Positions reach past the left/top patch margins and the image box.
    x = torch.tensor(rng.uniform(-1, 300, n), dtype=torch.float32, device=cuda)
    y = torch.tensor(rng.uniform(-1, 200, n), dtype=torch.float32, device=cuda)
    s = torch.tensor(rng.uniform(0.9, 2.4, n), dtype=torch.float32, device=cuda)
    o = torch.tensor(rng.uniform(0, 360, n), dtype=torch.float32, device=cuda)
    return img, x, y, s, o, torch.tensor(live, dtype=torch.int32, device=cuda)


def test_orient_kernel_matches_plain(cuda):
    img, x, y, s, _, count = front_packed(cuda)
    got = orient.orientation_histograms(img, x, y, s, count)
    ref = orient.orientation_histograms_plain(img, x, y, s, count)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert not got[50:].any() and bool((got[:50].sum(dim=1) > 0).all())
    assert torch.equal(got, orient.orientation_histograms(img, x, y, s, count))


def test_descriptor_kernel_matches_plain(cuda):
    img, x, y, s, o, count = front_packed(cuda)
    got = descriptor.extract_descriptors(img, x, y, s, o, count)
    ref = descriptor.extract_descriptors_plain(img, x, y, s, o, count)
    assert float((got - ref).abs().max()) <= 1e-5
    torch.testing.assert_close(got[:50].norm(dim=1), torch.ones(50, device=cuda),
                               rtol=0, atol=1e-4)
    assert not got[50:].any()
    assert torch.equal(got, descriptor.extract_descriptors(img, x, y, s, o, count))


def test_sweep_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(57)
    d1 = torch.nn.functional.normalize(torch.randn(300, 128, device=cuda, generator=g), dim=1)
    d2 = torch.nn.functional.normalize(torch.randn(2500, 128, device=cuda, generator=g), dim=1)
    d2[[40, 2100]] = d1[5]                     # a tie across chunks: lowest index wins
    for n1, n2 in ((300, 2500), (270, 1901), (300, 1)):
        before = match.SWEEP_KERNEL.launches
        got = match.match_descriptors(d1, d2, n1, n2, rescore_k=8)
        assert match.SWEEP_KERNEL.launches == before + 1
        ref = match_plain.match_descriptors_hybrid(d1, d2, n1, n2, 8)
        assert torch.equal(got[2], ref[2])
        torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=1e-7)
        exact = match.match_descriptors(d1, d2, n1, n2)
        assert torch.equal(got[2], exact[2])
        torch.testing.assert_close(got[0], exact[0], rtol=0, atol=1e-5)
    cs, ci = match.sweep_candidates(d1, d2, 270, 1901)
    ps, pi = match_plain.sweep_candidates(d1, d2, 270, 1901)
    assert torch.equal(ci, pi)
    torch.testing.assert_close(cs, ps, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_pallas_compact", [False, True])
def test_split_pipeline_on_card_matches_cpu(cuda, use_pallas_compact):
    img = make_test_image(192, 256, seed=58)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048, use_fused=False,
                           use_pallas_compact=use_pallas_compact)
    counts = {k: k.launches for k in (compact.KERNEL, orient.KERNEL, descriptor.KERNEL,
                                      orient_desc.KERNEL)}
    on_gpu = ct.extract_sift(torch.as_tensor(img, device=cuda), params)
    again = ct.extract_sift(torch.as_tensor(img, device=cuda), params)
    launched = {k.name: k.launches - c for k, c in counts.items()}
    assert launched["orient"] == launched["descriptor"] == 6 and launched["orient_desc"] == 0
    assert launched["compact"] == (6 if use_pallas_compact else 0)
    on_cpu = ct.extract_sift(img, params, device="cpu")
    n = int(on_cpu.num_pts)
    assert int(on_gpu.num_pts) == n and n > 30
    torch.testing.assert_close(on_gpu.xpos.cpu(), on_cpu.xpos, rtol=1e-5, atol=1e-4)
    assert torch.equal(on_gpu.data, again.data)


def test_acquire_kernels_match_plain(cuda):
    img, oy, ox, rxy = acquire.bench_inputs(256, 200, 640, seed=59)
    edge = (np.arange(64 * 300, dtype=np.float32).reshape(64, 300) % 97,
            np.array([0, 8, 16, 60, -5, 0, 3, 8], np.int32),
            np.array([0, 128, 44, 250, 0, -9, 7, 0], np.int32),
            np.array([0, 7, 60, -3, 2, 9, 1, 55, 0, 127, 300, -1, 5, 200, 3, 250], np.int32))
    for arrays in ((img, oy, ox, rxy), edge):
        args = tuple(torch.as_tensor(a, device=cuda) for a in arrays)
        for name, staged, roll in acquire.VARIANTS:
            kern = acquire.KERNELS[(staged, roll)]
            before = kern.launches
            got = acquire.acquire(*args, staged=staged, roll=roll)
            assert kern.launches == before + 1, name
            ref = acquire.acquire_plain(*args, roll)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=0, msg=name)
            assert not got[:, 1:].any()


def test_probe_kernels_pass_and_match_plain(cuda):
    for p in probes.PROBES:
        args = p.inputs(cuda)
        before = p.kernel.launches
        out = p.fn(*args)
        assert p.kernel.launches == before + 1, p.name
        ok, err = p.judge(out.cpu().numpy(), args)
        assert ok, (p.name, err)
        torch.testing.assert_close(out, p.plain(*args), rtol=0, atol=1e-3, msg=p.name)
    assert all(ok for ok, _ in probes.run_probes(cuda).values())


def test_fast_pipeline_on_card_matches_cpu(cuda):
    img = make_test_image(192, 256, seed=60)
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048, fast_gradients=True)
    before = orient_desc.KERNEL.launches
    on_gpu = ct.extract_sift(img, params)                 # an array goes to the card
    assert on_gpu.device.type == "cuda" and orient_desc.KERNEL.launches == before + 3
    on_cpu = ct.extract_sift(img, params, device="cpu")
    n = int(on_cpu.num_pts)
    assert int(on_gpu.num_pts) == n and n > 30
    torch.testing.assert_close(on_gpu.xpos.cpu(), on_cpu.xpos, rtol=1e-5, atol=1e-4)
    row = (on_gpu.data.cpu() - on_cpu.data).abs().max(dim=1).values[:n]
    assert float(row.median()) < 4e-3


def test_cli_on_card(cuda, tmp_path, capsys):
    h, w = 320, 480
    a = synth.make_leaves_image(h, w, seed=0)
    left, right = str(tmp_path / "l.pgm"), str(tmp_path / "r.pgm")
    io.write_pgm(left, a)
    io.write_pgm(right, synth.warp_image(a, synth.known_homography(h, w)))
    out = str(tmp_path / "annotated.pgm")
    before = {k: k.launches for k in FUSED_PATH}
    assert cli.main(["--left", left, "--right", right, "--octaves", "3", "--max-pts", "2048",
                     "--num-loops", "512", "--json", "--time", "--out", out]) == 0
    assert all(k.launches > before[k] for k in FUSED_PATH)
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_pts1"] > 100 and metrics["overflow1"] == 0 and metrics["num_fit"] > 50
    assert metrics["extract_ms"] > 0 and metrics["match_ms"] > 0
    assert io.read_pgm(out).shape == (h, w)
