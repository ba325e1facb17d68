"""The port's demo CLI and its host utilities: PGM I/O and the C++ record
codec against the JAX package's, the match drawing against the JAX
package's, and ``python -m cudasift_tpu_torch.cli`` on the CPU."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from cudasift_tpu import sift_data as jsd
from cudasift_tpu.utils import io as jio
from cudasift_tpu.utils import native as jnative
from cudasift_tpu.utils import viz as jviz

from cudasift_tpu_torch import cli
from cudasift_tpu_torch.convert import sift_data_from_numpy
from cudasift_tpu_torch.utils import io, native, synth, viz

# The JAX CLI's metrics keys (cudasift_tpu/cli.py:111-122).
CLI_KEYS = {"num_pts1", "num_pts2", "overflow1", "overflow2", "num_fit", "num_matches",
            "match_rate_pct", "first_call_ms"}


def point_arrays(n=40, cap=64, seed=0):
    """Field arrays of a SiftData with ``n`` points, matches (some
    missing), match errors, and points near every border."""
    rng = np.random.default_rng(seed)
    arrays = {f.name: np.asarray(getattr(jsd.init_sift_data(cap), f.name)).copy()
              for f in dataclasses.fields(jsd.SiftData)}
    arrays["num_pts"] = np.int32(n)
    xs = rng.uniform(0, 120, n)
    ys = rng.uniform(0, 90, n)
    xs[:4] = [0.2, 119.6, 3.0, 60.0]
    ys[:4] = [45.0, 2.0, 89.7, 0.4]
    for name, v in (("xpos", xs), ("ypos", ys), ("scale", rng.uniform(0.8, 6.0, n)),
                    ("sharpness", rng.uniform(3, 30, n)), ("edgeness", rng.uniform(1, 9, n)),
                    ("orientation", rng.uniform(0, 360, n)), ("score", rng.uniform(0.5, 1, n)),
                    ("ambiguity", rng.uniform(0.3, 1, n)), ("match_xpos", xs + 5),
                    ("match_ypos", ys - 3), ("match_error", rng.uniform(0, 8, n)),
                    ("subsampling", rng.choice([1.0, 2.0, 4.0], n))):
        arrays[name][:n] = v.astype(np.float32)
    match = rng.integers(-1, cap, n).astype(np.int32)
    match[5] = -1
    arrays["match"][:n] = match
    arrays["data"][:n] = rng.uniform(0, 0.3, (n, 128)).astype(np.float32)
    return arrays


def both(arrays):
    """The same SiftData in the JAX package's class and the port's."""
    return (jsd.SiftData(**{k: np.asarray(v) for k, v in arrays.items()}),
            sift_data_from_numpy(arrays, device="cpu"))


def test_pgm_files_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(-20, 280, (37, 53)).astype(np.float32)
    ours, theirs = tmp_path / "ours.pgm", tmp_path / "theirs.pgm"
    io.write_pgm(str(ours), img)
    jio.write_pgm(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(io.read_pgm(str(ours)), jio.read_pgm(str(ours)))
    # ASCII P2 with a comment, and 16-bit P5.
    ascii_pgm = tmp_path / "a.pgm"
    ascii_pgm.write_bytes(b"P2\n# a comment\n4 3\n255\n0 1 2 3\n4 5 6 7\n8 9 10 255\n")
    got = io.read_pgm(str(ascii_pgm))
    np.testing.assert_array_equal(got, jio.read_pgm(str(ascii_pgm)))
    assert got.shape == (3, 4) and got[2, 3] == 255
    wide = tmp_path / "w.pgm"
    wide.write_bytes(b"P5\n3 2\n65535\n" + np.array([[1, 300, 65535], [0, 7, 256]], ">u2").tobytes())
    np.testing.assert_array_equal(io.read_pgm(str(wide)), jio.read_pgm(str(wide)))
    assert io.imread_gray(str(ours)).dtype == np.float32


@pytest.mark.parametrize("codec", ["g++", "numpy"])
def test_records_equal_jax_and_round_trip(codec, monkeypatch, tmp_path):
    if codec == "numpy":
        monkeypatch.setattr(native, "_module", False)
    assert native.have_native() == (codec == "g++" and shutil.which("g++") is not None)
    arrays = point_arrays()
    jdata, tdata = both(arrays)
    blob = native.to_cudasift_records(tdata)
    assert blob == jnative.to_cudasift_records(jdata)
    assert len(blob) == 40 * 144 * 4
    back = native.from_cudasift_records(blob, device="cpu")
    jback = jnative.from_cudasift_records(blob)
    assert back.device.type == "cpu" and back.max_pts == 128
    for f in dataclasses.fields(jsd.SiftData):
        np.testing.assert_array_equal(getattr(back, f.name).numpy(),
                                      np.asarray(getattr(jback, f.name)), err_msg=f.name)
    n = 40
    for name in ("xpos", "match", "match_error", "subsampling", "data"):
        np.testing.assert_array_equal(getattr(back, name)[:n].numpy(), arrays[name][:n])
    # The PGM codec of the same build.
    img = np.random.default_rng(2).uniform(0, 255, (24, 31)).astype(np.float32)
    path = str(tmp_path / "n.pgm")
    io.write_pgm(path, img)
    np.testing.assert_array_equal(native.read_pgm_native(path), io.read_pgm(path))
    native.write_pgm_native(path, img)
    assert np.abs(io.read_pgm(path) - img).max() <= 1.0


def test_draw_match_data_equals_jax():
    arrays = point_arrays()
    img = np.random.default_rng(3).uniform(0, 255, (90, 120)).astype(np.float32)
    j1, t1 = both(arrays)
    other = point_arrays(n=64, seed=4)
    j2, t2 = both(other)
    got = viz.draw_match_data(t1, t2, img)
    np.testing.assert_array_equal(got, jviz.draw_match_data(j1, j2, img))
    assert (got == 255).sum() > 100 and not np.array_equal(got, img)


def pgm_pair(tmp_path, h=320, w=480):
    a = synth.make_leaves_image(h, w, seed=0)
    b = synth.warp_image(a, synth.known_homography(h, w))
    left, right = str(tmp_path / "l.pgm"), str(tmp_path / "r.pgm")
    io.write_pgm(left, a)
    io.write_pgm(right, b)
    return left, right


def test_cli_on_cpu(tmp_path, capsys):
    left, right = pgm_pair(tmp_path)
    out = str(tmp_path / "annotated.pgm")
    rc = cli.main(["--device", "cpu", "--left", left, "--right", right, "--octaves", "3",
                   "--max-pts", "2048", "--num-loops", "512", "--json", "--out", out])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Image size = (480,320)"
    assert any(line.startswith("Number of matching features:") for line in lines)
    metrics = json.loads(lines[-1])
    assert set(metrics) == CLI_KEYS
    assert metrics["num_pts1"] > 100 and metrics["num_fit"] > 50
    assert metrics["overflow1"] == metrics["overflow2"] == 0
    annotated = io.read_pgm(out)
    assert annotated.shape == (320, 480)
    assert (annotated == 255).sum() > 500


def test_cli_raises_without_a_card(tmp_path, capsys, monkeypatch):
    """With no card and no --device cpu the CLI raises before it reads or
    runs anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left, right = pgm_pair(tmp_path, 64, 96)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["--left", left, "--right", right, "--json"])
    assert capsys.readouterr().out == ""
