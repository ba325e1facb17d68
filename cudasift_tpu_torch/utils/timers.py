"""Device timing with CUDA events (the analogue of TimerGPU,
cudautils.h:61-107)."""

from __future__ import annotations

import torch


def time_ms(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Median device time (ms) of ``fn(*args)`` on the current CUDA stream,
    each call bracketed by its own pair of CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ms measures CUDA work; no CUDA device is available")
    for _ in range(warmup):
        fn(*args)
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]
