"""Device time a frame of the extraction program's ``extract.merge`` stage
(the cross-octave merge and the result's fields), from the program's own
stage markers over every request of the window."""

from siftbench import programtrace

NAME = "merge_ms.frames"
UNIT = "ms"
LAYER = "plain PyTorch stages (ops/convolve.py, ops/detect.py, pipeline.py)"
SOURCE = "program_span"


def read(reading):
    return programtrace.stage_ms(reading, "extract.merge", "extract.pyramid")
