"""Device time of one ``extract_sift`` call (copy-in, graph replay, output
clones), by CUDA events that the benchmark records around each call over the
whole window."""

NAME = "extract_device_ms.frames"
UNIT = "ms"
LAYER = "extraction program (pipeline.py, utils/jit.py)"
SOURCE = "program_span"


def read(reading):
    ms = reading.spans.get("extract_sift")
    return sum(ms) / len(ms) if ms else None
