"""``cudasift_tpu_torch.parallel`` on the CPU against the JAX package's
``parallel`` on its virtual CPU devices (``tests/conftest.py``): the
column-sharded matcher, data-parallel extraction, the mesh, the dry run,
and the matcher's (best, second, index) entry that the sharded merge takes.
A port ``Mesh`` of repeated CPU entries runs real splits and merges."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import golden
import cudasift_tpu as cs
from cudasift_tpu import parallel as jpar

import cudasift_tpu_torch as ct
from cudasift_tpu_torch import parallel as tpar
from cudasift_tpu_torch.ops import match as tmatch
from cudasift_tpu_torch.ops.cuda import match as kmatch
from cudasift_tpu_torch.parallel.dryrun import dryrun_multichip
from cudasift_tpu_torch.utils.synth import make_test_image

N_DEV = 4
CPU_MESH = tpar.Mesh((torch.device("cpu"),) * N_DEV)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's CPU work. The suite runs files in
    parallel worker processes; a worker spinning a full OpenMP pool beside
    the others slows every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= N_DEV, "conftest must provide the virtual devices"
    return jpar.make_mesh(N_DEV)


def unit_rows(rng, n):
    d = rng.standard_normal((n, 128)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


# A ragged n2 inside the last shard (tests/test_parallel.py's case), and one
# that leaves the last three of four 256-column shards without a live column.
@pytest.mark.parametrize("n1,n2", [(200, 977), (150, 100)])
def test_sharded_matcher_matches_jax(jax_mesh, n1, n2):
    rng = np.random.default_rng(42)
    d1, d2 = unit_rows(rng, 200), unit_rows(rng, 1000)
    best, amb, idx = (o.numpy() for o in tpar.match_descriptors_sharded(
        torch.as_tensor(d1), torch.as_tensor(d2), n1, n2, CPU_MESH, tile=64))
    jb, ja, ji = (np.asarray(o) for o in jpar.match_descriptors_sharded(
        jnp.asarray(d1), jnp.asarray(d2), jnp.int32(n1), jnp.int32(n2), jax_mesh, tile=64))
    gb, ga, gi = golden.match_brute_force(d1[:n1].astype(np.float64),
                                          d2[:n2].astype(np.float64))
    np.testing.assert_array_equal(idx[:n1], ji[:n1])
    np.testing.assert_array_equal(idx[:n1], gi)
    # Rows past n1: zero here, as the single-device matcher returns them;
    # the JAX package's sharded matcher leaves them unmasked.
    np.testing.assert_allclose(best[:n1], jb[:n1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(amb[:n1], ja[:n1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(best[:n1], gb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(amb[:n1], ga, rtol=1e-4, atol=1e-5)
    assert not best[n1:].any() and not amb[n1:].any() and not idx[n1:].any()
    # The merge of the shards' triples is the single-device matcher's result.
    single = tmatch.match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2), n1, n2, tile=64)
    np.testing.assert_array_equal(idx, single[2].numpy())
    np.testing.assert_array_equal(best, single[0].numpy())


@pytest.mark.parametrize("entry", ["throughput_sharded", "batched"])
def test_sharded_extraction_matches_jax(jax_mesh, entry):
    """Four 96x128 frames on a four-entry mesh against the JAX package's
    same entry (bars of tests/test_torch_pipeline.py), and against the
    port's single calls exactly."""
    frames = np.stack([make_test_image(96, 128, seed=s) for s in (61, 62, 63, 64)])
    kw = dict(num_octaves=2, thresh=2.0, max_pts=512)
    jfn = getattr(jpar, f"extract_sift_{entry}")
    tfn = getattr(tpar, f"extract_sift_{entry}")
    jd = jfn(jnp.asarray(frames), cs.SiftParams(**kw), jax_mesh)
    tparams = ct.SiftParams(grad_mode="exact", **kw)
    td = tfn(frames, tparams, CPU_MESH)
    assert td.num_pts.shape == (4,) and td.data.shape == (4, 512, 128)
    assert td.xpos.device.type == "cpu"
    for i in range(4):
        nj, nt = int(jd.num_pts[i]), int(td.num_pts[i])
        assert nt > 20 and abs(nt - nj) <= max(2, nj // 50), (i, nt, nj)
        kj = {tuple(np.round([float(jd.xpos[i, k]), float(jd.ypos[i, k]),
                              float(jd.scale[i, k])], 2)) for k in range(nj)}
        kt = {tuple(np.round([float(td.xpos[i, k]), float(td.ypos[i, k]),
                              float(td.scale[i, k])], 2)) for k in range(nt)}
        assert len(kj & kt) / max(len(kj), len(kt)) >= 0.97, i
        assert int(td.overflow[i]) == int(jd.overflow[i]) == 0
        single = ct.extract_sift(frames[i], tparams, device="cpu")
        for f in ct.SiftData.__dataclass_fields__:
            assert torch.equal(getattr(td, f)[i], getattr(single, f)), (i, f)


def test_indivisible_batch_and_the_mesh(jax_mesh):
    frames = np.stack([make_test_image(48, 64, seed=s) for s in (1, 2, 3)])
    params = ct.SiftParams(num_octaves=2)
    for fn in (tpar.extract_sift_throughput_sharded, tpar.extract_sift_batched):
        with pytest.raises(ValueError, match="not divisible"):
            fn(frames, params, CPU_MESH)
    with pytest.raises(ValueError):
        jpar.extract_sift_throughput_sharded(frames, cs.SiftParams(num_octaves=2), jax_mesh)
    # Without a mesh: one program on the frames' device, as
    # extract_sift_throughput.
    plain = tpar.extract_sift_batched(torch.as_tensor(frames), params)
    ref = ct.extract_sift_throughput(frames, params, device="cpu")
    for f in ct.SiftData.__dataclass_fields__:
        assert torch.equal(getattr(plain, f), getattr(ref, f)), f
    mesh = tpar.make_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.size == 1
    with pytest.raises(ValueError, match="available"):
        tpar.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_mesh()
    assert tpar.Mesh(["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        tpar.Mesh(())


def test_dryrun_on_the_cpu(capsys):
    out = dryrun_multichip(N_DEV, device="cpu")
    assert out["devices"] == ["cpu"] * N_DEV and len(out["num_pts"]) == N_DEV
    assert len(out["throughput_num_pts"]) == 2 * N_DEV and min(out["num_pts"]) > 100
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_top2_entry_against_the_unclamped_triple():
    """``match_top2`` (the plain entry and the wrapper on CPU tensors) is the
    float64 brute-force triple clamped at 0, zero past n1; the matcher's
    ambiguity is its second over best + 1e-6, bit for bit."""
    rng = np.random.default_rng(7)
    d1 = unit_rows(rng, 64)
    d2 = unit_rows(rng, 300)
    n1, n2 = 60, 8
    away = d2[:n2].sum(axis=0)
    d1[:8] = -away / np.linalg.norm(away)    # rows scoring below 0 on every live column
    scores = d1[:n1].astype(np.float64) @ d2[:n2].astype(np.float64).T
    gi = scores.argmax(axis=1)
    gb = scores[np.arange(n1), gi]
    masked = scores.copy()
    masked[np.arange(n1), gi] = -np.inf
    gs = masked.max(axis=1)
    assert (gb[:8] < 0).all()
    t1, t2 = torch.as_tensor(d1), torch.as_tensor(d2)
    for fn in (tmatch.match_top2, kmatch.match_top2):
        best, second, index = (o.numpy() for o in fn(t1, t2, n1, torch.tensor(n2), tile=4))
        np.testing.assert_array_equal(index[:n1], gi)
        np.testing.assert_allclose(best[:n1], np.maximum(gb, 0), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(second[:n1], np.maximum(gs, 0), rtol=1e-5, atol=1e-6)
        assert not best[n1:].any() and not second[n1:].any() and not index[n1:].any()
    best, second, index = tmatch.match_top2(t1, t2, n1, n2, tile=4)
    score, amb, idx = tmatch.match_descriptors(t1, t2, n1, n2, tile=4)
    assert torch.equal(score, best) and torch.equal(idx, index)
    assert torch.equal(amb, second / (best + 1e-6))
    # A mesh of devices without kernels raises in the kernel wrapper: the
    # sharded matcher has no path but the kernel off the CPU.
    meta = tpar.Mesh((torch.device("meta"),) * 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpar.match_descriptors_sharded(t1, t2, n1, n2, meta, tile=64)
