"""The readers of the program's own trace (``programtrace.py`` and the layer
files that use it) on a fixed synthetic snapshot and profiled stretch, and
None where the reading holds no snapshot."""

import types

import pytest

from siftbench.registry import Registry

SNAPSHOT = {
    "spans": [
        {"name": "extract_sift", "id": 0, "parent": -1, "root": 0, "start_ns": 90, "end_ns": 250},
        {"name": "jit.replay", "id": 1, "parent": 0, "root": 0, "start_ns": 100, "end_ns": 120},
        {"name": "extract_sift", "id": 2, "parent": -1, "root": 2, "start_ns": 350,
         "end_ns": 900},
        {"name": "readback", "id": 3, "parent": -1, "root": 3, "start_ns": 950, "end_ns": 990},
        {"name": "extract_sift", "id": 4, "parent": -1, "root": 4, "start_ns": 2000,
         "end_ns": 2600},
    ],
    "calls": [
        {"root": 0, "function": "_extract_sift_jit", "copy_in_ms": 0.01, "replay_ms": 1.3,
         "clone_ms": 0.02, "gap_ms": None},
        {"root": 2, "function": "_extract_sift_jit", "copy_in_ms": 0.01, "replay_ms": 1.3,
         "clone_ms": 0.02, "gap_ms": 0.2},
        {"root": 4, "function": "_extract_sift_jit", "copy_in_ms": 0.01, "replay_ms": 1.3,
         "clone_ms": 0.02, "gap_ms": 0.4},
        {"root": 4, "function": "_find_homography_jit", "copy_in_ms": 0.01, "replay_ms": 30.0,
         "clone_ms": 0.02, "gap_ms": 9.0},
    ],
    "stages": {
        "extract.pyramid": {"count": 2, "ms": 0.8, "self_ms": 0.8},
        "extract.octave": {"count": 10, "ms": 3.0, "self_ms": 0.6},
        "extract.compact": {"count": 10, "ms": 1.0, "self_ms": 1.0},
        "extract.merge": {"count": 2, "ms": 0.3, "self_ms": 0.3},
        "ransac.score": {"count": 4, "ms": 100.0, "self_ms": 100.0},
    },
    "programs": [
        {"function": "_extract_sift_jit", "traced": False, "replays": 5,
         "nodes": {"kernel": 361, "memcpy": 20}},
        {"function": "_extract_sift_jit", "traced": True, "replays": 9,
         "nodes": {"kernel": 361, "stamp": 33}},
        {"function": "_extract_batch_jit", "traced": False, "replays": 20, "nodes": {"kernel": 9}},
    ],
}


class Stretch:
    """A profiled stretch over request 0 alone, with three idle gaps."""

    requests = (0, 1)

    @staticmethod
    def gaps():
        return [(100, 200), (300, 500), (1000, 1100)]


EXPECTED = {
    "pyramid_ms.frames": 0.4,
    "compact_ms.frames": 0.5,
    "glue_ms.frames": 0.3,
    "merge_ms.frames": 0.15,
    "ransac_score_ms.pairs": 25.0,
    "graph_kernels.frames": 361.0,              # not the batch program's, nor the stamps
    "host_ms.frames": (550 + 600) / 2 / 1e6,    # the roots after the stretch
    "replay_gap_ms.frames": 0.3,
    "idle_in_program.frames": 75.0,             # gaps at 150 and 400 inside a root, 1050 not
    "idle_in_program.track": 75.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_fixed_snapshot(name):
    layer = Registry().layer(name)
    assert layer.NAME == name
    reading = types.SimpleNamespace(program=SNAPSHOT, profile=Stretch())
    assert layer.read(reading) == pytest.approx(EXPECTED[name])
    assert layer.read(types.SimpleNamespace(program=None, profile=Stretch())) is None
    # Nothing recorded (tracing was off): nothing but the counter reads.
    empty = dict(SNAPSHOT, spans=[], calls=[], stages={})
    got = layer.read(types.SimpleNamespace(program=empty, profile=Stretch()))
    assert got == (361.0 if name == "graph_kernels.frames" else None)
