"""One ``torch.profiler`` session over a stretch of a traced run's window,
read without writing a trace file.

The session records CUDA activity only: the device's kernels, copies and
sets, and the host's CUDA runtime and driver calls. It records no host
operators or ranges, which would slow the host's part of every request and
so read as device idle time that the untraced window does not have. It
starts in set-up, the warm requests run again under it, and a marker kernel
opens the stretch: the window's first requests. The stretch's length is the
host clock's time from the start of its first request to the end of its
last; the device is busy where any device activity after the marker covers
it. Under the session the host's part of a replayed program still slows
(CUPTI records each kernel of a graph as it launches), so the stretch's own
idle share overstates the window's: ``idle_share.*`` take the device's busy
time a request from here and the rate of the rest of the window, which runs
without the profiler.
Idle gaps are named by the runtime or driver call the host was inside, or as
host code outside any CUDA call.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

HOST_CODE = "host code outside CUDA calls"


@dataclasses.dataclass
class Activity:
    name: str
    start_ns: int
    end_ns: int


def _ns(e, which: str) -> int:
    if hasattr(e, f"{which}_ns"):
        return int(getattr(e, f"{which}_ns")())
    return int(getattr(e, f"{which}_us")() * 1000)


def _annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


# The kernel that ``mark`` launches; what ran before its end is not in the
# stretch.
MARKER = "spin_kernel"


def start():
    """A started profiler session that records CUDA activity only. Its start
    takes seconds (CUPTI sets up), so a run starts it in set-up."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def mark() -> None:
    """Open the stretch: one short marker kernel, waited for."""
    import torch

    torch.cuda._sleep(1)
    torch.cuda.synchronize()


class Profile:
    """What one profiler session saw over requests ``first`` to
    ``last - 1``: device activities and the host's CUDA calls, the spans
    those requests opened (``calls``, by name), the stretch's length on the
    host clock, the device's busy time and its idle gaps."""

    def __init__(self, prof, first: int, last: int, calls: collections.Counter,
                 stretch_s: float):
        import torch

        self.device: list[Activity] = []
        self.host: list[Activity] = []
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            end = start + int(e.duration_ns()) if hasattr(e, "duration_ns") \
                else _ns(e, "end")
            if _annotation(e):
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                self.device.append(Activity(e.name(), start, end))
            elif e.name().startswith("cu"):
                self.host.append(Activity(e.name(), start, end))
        self.requests = (first, last)
        self.calls = calls
        self.stretch_s = stretch_s
        cut = max((a.end_ns for a in self.device if MARKER in a.name), default=None)
        if cut is not None:
            self.device = [a for a in self.device if a.start_ns >= cut]
            self.host = [a for a in self.host if a.start_ns >= cut]
        ends = [(a.start_ns, a.end_ns) for a in self.device + self.host]
        self.t0 = min((s for s, _ in ends), default=0) if cut is None else cut
        self.t1 = max((e for _, e in ends), default=0)
        self.busy = _union([(a.start_ns, a.end_ns) for a in self.device])
        self.host.sort(key=lambda a: a.start_ns)
        self._host_starts = [a.start_ns for a in self.host]

    @property
    def window_s(self) -> float:
        return self.stretch_s

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self, match) -> float:
        """Seconds of device activities whose name satisfies ``match``."""
        return sum(a.end_ns - a.start_ns for a in self.device if match(a.name)) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        edges = [self.t0] + [t for iv in self.busy for t in iv] + [self.t1]
        return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]

    def host_at(self, t: int) -> str:
        """The innermost CUDA call the host was inside at time ``t`` (a
        driver call nests inside the runtime call that made it)."""
        k = bisect.bisect_right(self._host_starts, t) - 1
        for a in self.host[max(k - 3, 0):k + 1][::-1]:
            if a.start_ns <= t < a.end_ns:
                return a.name
        return HOST_CODE

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the idle time
        by what the host was doing in the middle of each gap."""
        ops: collections.Counter = collections.Counter()
        for a in self.device:
            ops[short_name(a.name)] += (a.end_ns - a.start_ns) / 1e9
        idle: collections.Counter = collections.Counter()
        for s, e in self.gaps():
            idle[self.host_at((s + e) // 2)] += (e - s) / 1e9
        return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(10)]}


def short_name(name: str, limit: int = 96) -> str:
    """A device activity's name without its trailing argument list, cut to
    ``limit`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            if name[i] == ")":
                depth += 1
            elif name[i] == "(":
                depth -= 1
                if depth == 0:
                    name = name[:i].rstrip() or name
                    break
    return name[:limit]
