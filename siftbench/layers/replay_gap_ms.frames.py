"""Device time from the end of one extraction call (its clones) to the
start of the next call's copy-in, from the program's ``jit.call`` events:
mean over the requests after the profiled stretch. The time the device
waits on the host between frames."""

from siftbench import programtrace

NAME = "replay_gap_ms.frames"
UNIT = "ms"
LAYER = "extraction program (pipeline.py, utils/jit.py)"
SOURCE = "program_span"


def read(reading):
    snap = programtrace.snapshot(reading)
    if not snap:
        return None
    after = {s["id"] for s in
             programtrace.roots(snap, "extract_sift")[programtrace.after_stretch(reading):]}
    gaps = [c["gap_ms"] for c in snap["calls"]
            if c["function"] == "_extract_sift_jit" and c["root"] in after
            and c["gap_ms"] is not None]
    return sum(gaps) / len(gaps) if gaps else None
