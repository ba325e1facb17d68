"""What the per-layer metrics of the measured program's own trace read: the
snapshot of its tracing module, ``cudasift_tpu_torch.utils.trace``.

A run hands the snapshot over as ``reading.program``. Where the reading has
no such field, the live module's snapshot is read, if the measured package
has the module and is loaded: its counters are always on, while its spans
and stages exist only where tracing was turned on. Every function returns
None where there is nothing to read, so a reader of a program without the
module, or of the control, gives no metric.
"""

from __future__ import annotations

import bisect
import sys

MODULE = "cudasift_tpu_torch.utils.trace"


def snapshot(reading) -> dict | None:
    if hasattr(reading, "program"):
        return reading.program
    mod = sys.modules.get(MODULE)
    return mod.snapshot() if mod is not None else None


def stage_ms(reading, name: str, per: str, which: str = "ms") -> float | None:
    """Stage ``name``'s total (``ms`` or ``self_ms``) over the count of stage
    ``per``: ``per`` = ``extract.pyramid`` gives a frame's, ``per`` =
    ``name`` one interval's."""
    snap = snapshot(reading)
    stages = snap.get("stages", {}) if snap else {}
    if name not in stages or not stages.get(per, {}).get("count"):
        return None
    return stages[name][which] / stages[per]["count"]


def roots(snap: dict, name: str) -> list[dict]:
    """The root spans named ``name``, in the order they opened."""
    return [s for s in snap["spans"] if s["parent"] == -1 and s["name"] == name]


def after_stretch(reading) -> int:
    """The first request after the profiled stretch (0 without one)."""
    return reading.profile.requests[1] if reading.profile is not None else 0


def idle_in_program(reading) -> float | None:
    """Of the profiled stretch's device-idle time, the share (%) whose gaps'
    midpoints fall inside one of the program's root spans: the host was in
    the program, not in the caller, while the device waited."""
    snap = snapshot(reading)
    p = reading.profile
    if not snap or p is None:
        return None
    spans = sorted((s["start_ns"], s["end_ns"]) for s in snap["spans"]
                   if s["parent"] == -1 and s["end_ns"])
    gaps = p.gaps()
    total = sum(e - s for s, e in gaps)
    if not spans or total <= 0:
        return None
    starts = [s for s, _ in spans]
    inside = 0
    for s, e in gaps:
        mid = (s + e) // 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and mid < spans[k][1]:
            inside += e - s
    return 100.0 * inside / total
