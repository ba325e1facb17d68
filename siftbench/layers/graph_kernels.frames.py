"""Kernel nodes of the replayed extraction graph: the kernels a frame
launches, counted by the program when it captures the graph. Of the
extraction programs the one replayed most."""

from siftbench import programtrace

NAME = "graph_kernels.frames"
UNIT = "kernels"
LAYER = "extraction program (pipeline.py, utils/jit.py)"
SOURCE = "program_counter"


def read(reading):
    snap = programtrace.snapshot(reading)
    programs = [p for p in (snap or {}).get("programs", [])
                if p["function"] == "_extract_sift_jit" and p["nodes"] and p["replays"]]
    if not programs:
        return None
    return float(max(programs, key=lambda p: p["replays"])["nodes"].get("kernel", 0))
