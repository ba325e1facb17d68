"""Timing (the analogue of TimerGPU and TimerCPU, cudautils.h:61-107):
``time_ms``, device time of single calls from CUDA events; ``time_ms_loop``,
device time per call of many calls back to back; ``time_ms_graph``, device
time per call of many calls replayed from one CUDA graph, without the host's
dispatch; ``time_fn``, the wall time of a call on either device, as the JAX
package's ``utils.timers.time_fn``."""

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


def time_ms_loop(fn, *args, n: int = 50, warmup: int = 3) -> float:
    """Device time (ms) per call of ``fn(*args)``: one pair of CUDA events
    around ``n`` back-to-back calls, divided by ``n``. While the host
    enqueues faster than the card runs, the calls queue up and the host's
    per-call dispatch is hidden; a call that waits for the host (a count
    copied from a Python int) still pays it, so pass counts as tensors on
    the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ms_loop measures CUDA work; no CUDA device is available")
    if n < 1:
        raise ValueError(f"n must be at least 1, got {n}")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_ms_graph(fn, *args, n: int = 100, warmup: int = 3) -> float:
    """Device time (ms) per call of ``fn(*args)`` without the host's
    dispatch: after ``warmup`` calls on a side stream, ``n`` calls are
    captured in one ``torch.cuda.CUDAGraph``, and one replay of it is timed
    between two CUDA events. ``fn`` must not wait for the host (a count
    copied from a Python int, a size read back), or the capture fails."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ms_graph measures CUDA work; no CUDA device is available")
    if n < 1:
        raise ValueError(f"n must be at least 1, got {n}")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn(*args)
    graph.replay()                      # the first replay uploads the graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


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
