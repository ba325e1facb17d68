"""Device time of one ``find_homography`` call (the draws, the copy-in, the
RANSAC program's replay and its output clones), by CUDA events around each
call over the whole window."""

NAME = "ransac_ms.pairs"
UNIT = "ms"
LAYER = "homography programs (ops/homography.py, ops/linalg.py)"
SOURCE = "program_span"


def read(reading):
    ms = reading.spans.get("find_homography")
    return sum(ms) / len(ms) if ms else None
