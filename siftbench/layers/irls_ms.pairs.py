"""Device time of one ``improve_homography`` call (copy-in, the refinement
program's replay, output clones), by CUDA events around each call over the
whole window."""

NAME = "irls_ms.pairs"
UNIT = "ms"
LAYER = "homography programs (ops/homography.py, ops/linalg.py)"
SOURCE = "program_span"


def read(reading):
    ms = reading.spans.get("improve_homography")
    return sum(ms) / len(ms) if ms else None
