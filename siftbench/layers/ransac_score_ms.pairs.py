"""Device time a pair of the RANSAC program's ``ransac.score`` stage (every
hypothesis scored against every matched point), from the program's own
stage markers over every request of the window."""

from siftbench import programtrace

NAME = "ransac_score_ms.pairs"
UNIT = "ms"
LAYER = "homography programs (ops/homography.py, ops/linalg.py)"
SOURCE = "program_span"


def read(reading):
    return programtrace.stage_ms(reading, "ransac.score", "ransac.score")
