"""Plain versions of the DoG (K1), refine (K2) and matcher (K4) kernels
against the JAX package's Pallas kernels in interpret mode and its XLA
versions; the wrappers' dispatch on CPU tensors."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudasift_tpu.config import laplace_kernels
from cudasift_tpu.ops import convolve as jconv
from cudasift_tpu.ops import detect as jdet
from cudasift_tpu.ops import match as jmatch
from cudasift_tpu.ops.pallas.dog import dog_and_mask_pallas
from cudasift_tpu.ops.pallas.match import match_descriptors_pallas
from cudasift_tpu.ops.pallas.refine import refine_candidates_pallas

from cudasift_tpu_torch.ops import match as tmatch
from cudasift_tpu_torch.ops.cuda import (FUSED_PATH, KERNELS, LIBRARY, SPLIT_PATH, acquire,
                                         compact, descriptor, dog, match, orient, orient_desc,
                                         probes, refine)
from cudasift_tpu_torch.utils.synth import make_test_image


def t(a):
    return torch.tensor(np.asarray(a))


def mask_set(m):
    return set(zip(*np.nonzero(np.asarray(m))))


def test_dog_plain_matches_pallas_and_xla():
    img = make_test_image(70, 150, seed=11)
    ktab = laplace_kernels(2)[0]
    launches = dog.KERNEL.launches
    ours_dog, ours_mask = dog.dog_and_mask(t(img), ktab, 0.8, 10.0)
    assert dog.KERNEL.launches == launches          # CPU tensors: plain version
    plain = dog.dog_and_mask_plain(t(img), ktab, 0.8, 10.0)
    assert torch.equal(ours_dog, plain[0]) and torch.equal(ours_mask, plain[1])
    assert ours_dog.shape == (7, 70, 150) and ours_mask.dtype == torch.bool

    pdog, pmask = dog_and_mask_pallas(jnp.asarray(img), jnp.asarray(ktab), 0.8, 10.0,
                                      interpret=True)
    blur = jconv.blur_multi(jnp.asarray(img), ktab)
    xdog = blur[1:] - blur[:-1]
    xmask = jdet.extrema_mask(xdog, 0.8, 10.0)
    got = mask_set(ours_mask.numpy())
    assert len(got) > 20
    for ref_dog, ref_mask in ((pdog, pmask), (xdog, xmask)):
        np.testing.assert_allclose(ours_dog.numpy(), np.asarray(ref_dog),
                                   atol=2e-3, rtol=1e-4)
        ref = mask_set(ref_mask)
        assert len(got.symmetric_difference(ref)) <= max(1, len(ref) // 100)


def test_refine_plain_matches_pallas_with_edge_candidates():
    h, w = 80, 200
    img = make_test_image(h, w, seed=12)
    blur = jconv.blur_multi(jnp.asarray(img), laplace_kernels(1)[0])
    jdog = blur[1:] - blur[:-1]
    mask = jdet.extrema_mask(jdog, 2.0, 10.0)
    idx, cnt = jdet.compact_mask(mask, 64)
    # Candidates hugging every edge and straddling the TPU kernel's 128-lane
    # tile boundary, placed first so capacity never drops them.
    forced = [s * h * w + y * w + x for s in (0, 4) for y in (1, h - 2)
              for x in (1, 127, 128, w - 3, w - 2)]
    idx = np.concatenate([forced, np.asarray(idx)])[:64].astype(np.int32)
    cnt = np.int32(min(int(cnt) + len(forced), 64))
    launches = refine.KERNEL.launches
    ours = refine.refine_candidates(t(jdog), t(idx), torch.tensor(cnt), 10.0, 0.0)
    assert refine.KERNEL.launches == launches
    ref = refine_candidates_pallas(jdog, jnp.asarray(idx), jnp.asarray(cnt), 10.0, 0.0,
                                   interpret=True)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref[5]))
    assert ours.valid.any()
    for name, r in zip(("xpos", "ypos", "scale", "sharpness", "edgeness"), ref[:5]):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(r),
                                   rtol=3e-7, atol=0, err_msg=name)


def unit_rows(rng, n):
    d = rng.standard_normal((n, 128)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_match_plain_matches_pallas_and_xla(use_bf16):
    rng = np.random.default_rng(13)
    d1, d2 = unit_rows(rng, 300), unit_rows(rng, 500)
    n1, n2 = 300, 443
    launches = match.KERNEL.launches
    score, amb, idx = match.match_descriptors(t(d1), t(d2), n1, torch.tensor(n2, dtype=torch.int32),
                                              use_bf16=use_bf16, tile=128)
    assert match.KERNEL.launches == launches
    refs = [jmatch.match_descriptors(jnp.asarray(d1), jnp.asarray(d2), jnp.int32(n1),
                                     jnp.int32(n2), tile=256, use_bf16=use_bf16)]
    if not use_bf16:
        refs.append(match_descriptors_pallas(jnp.asarray(d1), jnp.asarray(d2), jnp.int32(n1),
                                             jnp.int32(n2), interpret=True))
    for rs, ra, ri in refs:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
        np.testing.assert_allclose(score.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(amb.numpy(), np.asarray(ra), rtol=1e-4, atol=1e-5)
    assert int(idx.max()) < n2


def test_match_ties_and_masks():
    rng = np.random.default_rng(14)
    d2 = unit_rows(rng, 40)
    d2[[9, 17, 30]] = d2[5]                      # four equal best columns
    d1 = np.repeat(d2[5:6], 3, axis=0)
    score, amb, idx = tmatch.match_descriptors(t(d1), t(d2), 3, 40, tile=8)
    assert idx.tolist() == [5, 5, 5]             # lowest index wins
    np.testing.assert_allclose(amb.numpy(), score.numpy() / (score.numpy() + 1e-6), rtol=1e-6)
    score, amb, idx = tmatch.match_descriptors(t(d1), t(d2), 3, 12, tile=8)
    assert idx.tolist() == [5, 5, 5] and float(amb[0]) == pytest.approx(1.0, abs=1e-5)
    score, amb, idx = tmatch.match_descriptors(t(d1), t(d2), 3, 5, tile=8)
    assert (idx < 5).all()                       # columns >= n2 never win
    score, amb, idx = tmatch.match_descriptors(t(d1), t(d2), 3, 0)
    assert not score.any() and not amb.any() and not idx.any()
    score, amb, idx = tmatch.match_descriptors(t(d1), t(d2), 1, 40)
    assert float(score[0]) > 0.99 and not score[1:].any() and not idx[1:].any()


def test_wrappers_reject_other_devices():
    meta = torch.device("meta")
    img = torch.empty((32, 32), device=meta)
    with pytest.raises(ValueError):
        dog.dog_and_mask(img, laplace_kernels(1)[0], 1.0)
    with pytest.raises(ValueError):
        refine.refine_candidates(torch.empty((7, 32, 32), device=meta),
                                 torch.empty((8,), dtype=torch.int32, device=meta),
                                 torch.empty((), dtype=torch.int32, device=meta), 10.0, 0.0)
    v = torch.empty((8,), device=meta)
    with pytest.raises(ValueError):
        orient_desc.orient_and_describe(img, v, v, v, torch.empty((8,), dtype=torch.bool,
                                                                  device=meta))
    with pytest.raises(ValueError):
        match.match_descriptors(torch.empty((8, 128), device=meta),
                                torch.empty((8, 128), device=meta), 8, 8)
    with pytest.raises(ValueError):
        orient_desc.orient_and_describe(t(np.zeros((8, 8), np.float32)), t(np.zeros(1, np.float32)),
                                        t(np.zeros(1, np.float32)), t(np.ones(1, np.float32)),
                                        torch.ones(1, dtype=torch.bool), mode="bogus")
    ivec = torch.empty((8,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        acquire.acquire(img, ivec, ivec, ivec)
    with pytest.raises(ValueError):
        probes.transpose(img)
    with pytest.raises(ValueError):
        compact.compact_mask(torch.empty((5, 32, 32), dtype=torch.bool, device=meta), 64)
    with pytest.raises(ValueError):
        orient.orientation_histograms(img, v, v, v, 8)
    with pytest.raises(ValueError):
        descriptor.extract_descriptors(img, v, v, v, v, 8)
    with pytest.raises(ValueError):
        match.match_descriptors(torch.empty((8, 128), device=meta),
                                torch.empty((8, 128), device=meta), 8, 8, rescore_k=8)
    assert [k.name for k in LIBRARY] == ["dog", "refine", "orient_desc", "match",
                                         "match_sweep", "orient", "descriptor", "compact"]
    assert all(k.replaces.startswith("cudasift_tpu/ops/pallas/") for k in LIBRARY)
    assert set(FUSED_PATH) | set(SPLIT_PATH) == set(LIBRARY) - {match.SWEEP_KERNEL}
    # Every kernel, the four acquisition launchers and eight probes with
    # them, has a name of its own and the pallas_call line it replaces.
    assert len(KERNELS) == 20 and len({k.name for k in KERNELS}) == 20
    rest = KERNELS[len(LIBRARY):]
    assert all(k.replaces.startswith(("benchmarks/acquire_bench.py:",
                                      "benchmarks/mosaic_probe.py:")) for k in rest)


def test_kernel_launches_on_its_tensors_device(monkeypatch):
    """A call for tensors on ``cuda:1`` enters that device's guard and
    launches on that device's current stream, whatever the current device
    is; nothing here needs a card."""
    import contextlib

    from cudasift_tpu_torch.utils.build import Kernel

    events = []

    def fake_launcher(*args):
        events.append(("launch", args))
        return 0

    class FakeStream:
        cuda_stream = 0xBEEF

    def fake_current_stream(device=None):
        events.append(("stream", device))
        return FakeStream()

    @contextlib.contextmanager
    def fake_guard(device):
        events.append(("enter", device))
        yield
        events.append(("exit", device))

    kern = Kernel("dog.cu", "dog_and_mask", [])
    monkeypatch.setattr(Kernel, "load", lambda self: fake_launcher)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_current_stream)
    monkeypatch.setattr(torch.cuda, "device", fake_guard)
    dev = torch.device("cuda", 1)
    kern(dev, 11, 22)
    assert events == [("enter", dev), ("stream", dev), ("launch", (11, 22, 0xBEEF)),
                      ("exit", dev)]
    assert kern.launches == 1
    # A launcher that reports an error raises and does not count.
    monkeypatch.setattr(Kernel, "load", lambda self: lambda *a: 700)
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        kern(dev, 11, 22)
    assert kern.launches == 1
