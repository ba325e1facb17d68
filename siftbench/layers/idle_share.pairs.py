"""The device's idle share in the window: 1 - (the device's busy time a
request, from the profiler's timeline over the traced stretch: the time any
kernel, copy or set ran) x (requests a second in the rest of the window,
which ran without the profiler). The stretch's own length is not used: under
the profiler the host's part of a replayed program slows by about 0.9 ms a
frame, which would read as idle time that the untraced window does not have."""

NAME = "idle_share.pairs"
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"


def read(reading):
    p = reading.profile
    if p is None or reading.untraced_rate is None or p.busy_s <= 0:
        return None
    first, last = p.requests
    return 100.0 * (1.0 - p.busy_s / (last - first) * reading.untraced_rate)
