"""Of the profiled stretch's device-idle time, the share whose gaps'
midpoints fall inside a host span of the program (its root spans, on the
profiler's clock): idle time the program's host part holds, not the
caller's."""

from siftbench import programtrace

NAME = "idle_in_program.frames"
UNIT = "%"
LAYER = "device"
SOURCE = "program_span"


def read(reading):
    return programtrace.idle_in_program(reading)
