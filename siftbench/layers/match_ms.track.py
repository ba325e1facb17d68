"""Device time of one eager ``match_sift_data`` call (K4 and the
elementwise fill of the matched fields), by CUDA events around each call over
the whole window."""

NAME = "match_ms.track"
UNIT = "ms"
LAYER = "matcher (ops/match.py)"
SOURCE = "program_span"


def read(reading):
    ms = reading.spans.get("match_sift_data")
    return sum(ms) / len(ms) if ms else None
