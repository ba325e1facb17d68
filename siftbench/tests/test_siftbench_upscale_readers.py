"""The numbers and readers of the 2x-upscale cell (``960p-upscale``): the
work counts of the upsampled pyramid and of ScaleUp, the stage reader on a
fixed synthetic snapshot, and the device-trace readers on a fixed profiled
stretch, each None where what it reads is absent, as in a program without
ScaleUp."""

import types

import pytest

from siftbench.registry import Registry


def test_dog_count_of_the_upscaled_1280x960_pyramid():
    """Under scale_up K1 blurs a pyramid whose octave 0 is 2560x1920."""
    dog = Registry().count("dog")
    assert dog.octave_pixels(1920, 2560, 5) == 6_547_200
    assert dog.octave_pixels(960, 1280, 5) == 1_636_800
    seconds, by = dog.bound_s(1920, 2560, 5)
    assert by == "operations" and seconds == pytest.approx(20.3e-6, rel=1e-2)


def test_scale_up_count_at_1280x960():
    """The frame read once and the 2560x1920 upsample written once."""
    up = Registry().count("scale_up")
    ops, nbytes = up.work(960, 1280)
    assert ops == 0.0 and nbytes == 4 * 960 * 1280 + 16 * 960 * 1280
    assert nbytes == pytest.approx(24.58e6, rel=1e-3)
    seconds, by = up.bound_s(960, 1280)
    assert by == "bytes" and seconds == pytest.approx(7.34e-6, rel=1e-3)


SNAPSHOT = {
    "spans": [],
    "calls": [],
    "stages": {
        "extract.pyramid": {"count": 2, "ms": 0.8, "self_ms": 0.7},
        "extract.upscale": {"count": 2, "ms": 0.1, "self_ms": 0.1},
        "extract.octave": {"count": 10, "ms": 3.0, "self_ms": 0.6},
    },
    "programs": [],
}


def test_upscale_stage_reader_on_a_fixed_snapshot():
    layer = Registry().layer("upscale_ms.upscale")
    assert layer.NAME == "upscale_ms.upscale"
    assert layer.read(types.SimpleNamespace(program=SNAPSHOT, profile=None)) \
        == pytest.approx(0.05)
    assert layer.read(types.SimpleNamespace(program=None, profile=None)) is None
    # A program without upscale has no such stage; tracing off records none.
    stages = {k: v for k, v in SNAPSHOT["stages"].items() if k != "extract.upscale"}
    for program in (dict(SNAPSHOT, stages=stages), dict(SNAPSHOT, stages={})):
        assert layer.read(types.SimpleNamespace(program=program, profile=None)) is None


class KernelStretch:
    """A profiled stretch of 10 frames with fixed device seconds by kernel
    name."""

    calls = {"extract_sift": 10}
    SECONDS = {"void (anonymous namespace)::dog_and_mask_kernel(float const*)": 400e-6,
               "void (anonymous namespace)::scale_up_kernel<true>(float const*)": 100e-6,
               "void at::native::elementwise_kernel<128, 2>(int)": 900e-6}

    def kernel_s(self, match):
        return sum(s for n, s in self.SECONDS.items() if match(n))


UPSCALE_CFG = {"frame": {"height": 960, "width": 1280},
               "sift": {"num_octaves": 5, "scale_up": True}}


@pytest.mark.parametrize("name,expected", [
    ("dog_roofline.upscale", 100.0 * (208 * 6_547_200 / 67e12) * 10 / 400e-6),  # 2560x1920
    ("upscale_kernel_ms.upscale", 1e3 * 100e-6 / 10),
])
def test_upscale_readers_on_a_fixed_stretch(name, expected):
    layer = Registry().layer(name)
    reading = types.SimpleNamespace(cfg=UPSCALE_CFG, registry=Registry(),
                                    profile=KernelStretch())
    assert layer.read(reading) == pytest.approx(expected)
    # Without its kernel in the stretch (a program without ScaleUp), or without
    # a stretch, nothing is read.
    gone = KernelStretch()
    gone.SECONDS = {n: s for n, s in KernelStretch.SECONDS.items() if layer.KERNEL not in n}
    assert layer.read(types.SimpleNamespace(cfg=UPSCALE_CFG, registry=Registry(),
                                            profile=gone)) is None
    assert layer.read(types.SimpleNamespace(cfg=UPSCALE_CFG, registry=Registry(),
                                            profile=None)) is None


def test_dog_roofline_upscale_counts_the_frame_without_upscale():
    layer = Registry().layer("dog_roofline.upscale")
    cfg = dict(UPSCALE_CFG, sift={"num_octaves": 5, "scale_up": False})
    reading = types.SimpleNamespace(cfg=cfg, registry=Registry(), profile=KernelStretch())
    frames = Registry().layer("dog_roofline.frames").read(reading)
    assert layer.read(reading) == pytest.approx(frames)
    up = types.SimpleNamespace(cfg=UPSCALE_CFG, registry=Registry(), profile=KernelStretch())
    assert layer.read(up) == pytest.approx(4 * frames)
