"""K4's share of its roofline: the least time the card needs for the
window's matches at their live counts (counts/match.py) over K4's device
time (its partial and merge kernels)."""

NAME = "match_roofline.track"
UNIT = "%"
LAYER = "hand-written kernels (csrc/)"
SOURCE = "device_trace"
KERNELS = ("match_partial_kernel", "match_merge_kernel")


def read(reading):
    p = reading.profile
    if p is None:
        return None
    seconds = p.kernel_s(lambda n: any(k in n for k in KERNELS))
    first, last = p.requests
    done = reading.log[first:last]
    if seconds <= 0 or not done:
        return None
    count = reading.registry.count("match")
    bound = sum(count.bound_s(r["n"], r["n_prev"])[0] for r in done)
    return 100.0 * bound / seconds
