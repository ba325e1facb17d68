"""Device time a frame of the extraction program's per-octave glue: the
self time of its ``extract.octave`` stages (each octave less its DoG,
compaction, refinement and descriptor stages), from the program's own stage
markers over every request of the window."""

from siftbench import programtrace

NAME = "glue_ms.frames"
UNIT = "ms"
LAYER = "plain PyTorch stages (ops/convolve.py, ops/detect.py, pipeline.py)"
SOURCE = "program_span"


def read(reading):
    return programtrace.stage_ms(reading, "extract.octave", "extract.pyramid", "self_ms")
