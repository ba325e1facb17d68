"""Kernel nodes of the replayed homography graphs: the kernels a pair's
``find_homography`` and ``improve_homography`` launch, counted by each
program when it captures its graph. Of each function's programs the one
replayed most; None unless both have one."""

from siftbench import programtrace

NAME = "homography_kernels.pairs"
UNIT = "kernels"
LAYER = "homography programs (ops/homography.py, ops/linalg.py)"
SOURCE = "program_counter"
FUNCTIONS = ("_find_homography_jit", "_improve_homography_jit")


def read(reading):
    snap = programtrace.snapshot(reading)
    total = 0.0
    for function in FUNCTIONS:
        programs = [p for p in (snap or {}).get("programs", [])
                    if p["function"] == function and p["nodes"] and p["replays"]]
        if not programs:
            return None
        total += max(programs, key=lambda p: p["replays"])["nodes"].get("kernel", 0)
    return total
