"""Host time of one ``extract_sift`` call, from the program's root span:
mean over the requests after the profiled stretch (the profiler slows the
host's part of a replay). Request k is the k-th ``extract_sift`` root."""

from siftbench import programtrace

NAME = "host_ms.frames"
UNIT = "ms"
LAYER = "extraction program (pipeline.py, utils/jit.py)"
SOURCE = "program_span"


def read(reading):
    snap = programtrace.snapshot(reading)
    if not snap:
        return None
    done = [s for s in programtrace.roots(snap, "extract_sift")[programtrace.after_stretch(reading):]
            if s["end_ns"]]
    if not done:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in done) / len(done) / 1e6
