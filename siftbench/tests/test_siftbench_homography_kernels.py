"""``homography_kernels.pairs`` on a fixed synthetic snapshot: the kernel
nodes of the two homography programs summed, each function's most replayed
program counted once; None where either program, or the snapshot, is
missing."""

import types

import pytest

from siftbench.registry import Registry

PROGRAMS = [
    {"function": "_extract_sift_jit", "traced": False, "replays": 40, "nodes": {"kernel": 361}},
    {"function": "_find_homography_jit", "traced": False, "replays": 16,
     "nodes": {"kernel": 412, "memcpy": 3}},
    {"function": "_find_homography_jit", "traced": True, "replays": 2,
     "nodes": {"kernel": 412, "stamp": 6}},
    {"function": "_improve_homography_jit", "traced": False, "replays": 16,
     "nodes": {"kernel": 455}},
    {"function": "_improve_homography_jit", "traced": False, "replays": 0,
     "nodes": {"kernel": 9999}},
]


def reading(programs):
    return types.SimpleNamespace(program={"spans": [], "calls": [], "stages": {},
                                          "programs": programs}, profile=None)


def test_sums_the_two_programs():
    layer = Registry().layer("homography_kernels.pairs")
    assert layer.NAME == "homography_kernels.pairs" and layer.UNIT == "kernels"
    assert layer.read(reading(PROGRAMS)) == pytest.approx(412 + 455)


@pytest.mark.parametrize("missing", ["_find_homography_jit", "_improve_homography_jit"])
def test_none_without_either_program(missing):
    layer = Registry().layer("homography_kernels.pairs")
    assert layer.read(reading([p for p in PROGRAMS if p["function"] != missing])) is None


def test_none_without_a_snapshot_or_a_card():
    layer = Registry().layer("homography_kernels.pairs")
    assert layer.read(types.SimpleNamespace(program=None, profile=None)) is None
    # Without a card a program's nodes are None.
    assert layer.read(reading([dict(p, nodes=None) for p in PROGRAMS])) is None
