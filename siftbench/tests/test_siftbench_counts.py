"""The work counts give the numbers the benchmark's rooflines rest on."""

import pytest

from siftbench.registry import Registry


def test_dog_count_at_1920x1080():
    dog = Registry().count("dog")
    assert dog.octave_pixels(1080, 1920, 5) == 2_762_040
    ops, nbytes = dog.work(1080, 1920, 5)
    assert ops == pytest.approx(0.5745e9, rel=1e-3)
    assert nbytes == pytest.approx(24.86e6, rel=1e-3)
    seconds, by = dog.bound_s(1080, 1920, 5)
    assert by == "operations" and seconds == pytest.approx(8.57e-6, rel=1e-3)
    assert nbytes / Registry().count("peaks").HBM_BYTES_S == pytest.approx(7.42e-6, rel=1e-3)


def test_match_count_at_the_leaves_pair():
    match = Registry().count("match")
    ops, nbytes = match.work(11210, 10176)
    assert ops == pytest.approx(29.2e9, rel=1e-3)
    assert nbytes == (11210 + 10176) * 512 + 11210 * 12
    seconds, by = match.bound_s(11210, 10176)
    assert by == "operations" and seconds == pytest.approx(59.0e-6, rel=1e-2)


def test_peaks_bound_takes_the_larger():
    peaks = Registry().count("peaks")
    assert peaks.bound_s(67e12, 0.0) == (1.0, "operations")
    assert peaks.bound_s(0.0, 3.35e12) == (1.0, "bytes")
