"""Device time a frame of the extraction program's ``extract.upscale``
stage (the ScaleUp kernel), read from the program's own stage markers over
every request of the window."""

from siftbench import programtrace

NAME = "upscale_ms.upscale"
UNIT = "ms"
LAYER = "hand-written kernels (csrc/)"
SOURCE = "program_span"


def read(reading):
    return programtrace.stage_ms(reading, "extract.upscale", "extract.pyramid")
