"""Device time a frame of the extraction program's ``extract.pyramid``
stage (the blurred base and its octaves), read from the program's own stage
markers over every request of the window."""

from siftbench import programtrace

NAME = "pyramid_ms.frames"
UNIT = "ms"
LAYER = "plain PyTorch stages (ops/convolve.py, ops/detect.py, pipeline.py)"
SOURCE = "program_span"


def read(reading):
    return programtrace.stage_ms(reading, "extract.pyramid", "extract.pyramid")
