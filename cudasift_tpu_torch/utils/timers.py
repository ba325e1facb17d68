"""Timing (the analogue of TimerGPU and TimerCPU, cudautils.h:61-107):
``time_ms``, device time from CUDA events; ``time_fn``, the wall time of a
call on either device, as the JAX package's ``utils.timers.time_fn``."""

from __future__ import annotations

import time

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


def _sync() -> None:
    """Wait for the card's queued work; CPU work is done when PyTorch
    returns."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Median wall time (ms) of ``fn(*args)`` on the host clock, each call
    waited for on the card when one is present (on the CPU it has finished
    when it returns)."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]
