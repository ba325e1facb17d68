"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result.

A run makes its frames from ``--seed``, warms every program the cell's
traffic uses (that is set-up), then sends requests in a closed loop for
``seconds``. Rates are all requests completed over the whole window; tails
are over all its requests. With ``trace`` the spans around each layer's
calls are on for the whole window and one profiler session, of CUDA activity
only, covers a stretch of it; the per-layer metrics come from that run.
After the window the requests kept as the sample are judged against the
plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, imports
from . import trace as tracing
from .flows import Spans
from .program import Port, Reference
from .registry import Registry
from .views import Views, derive

ROOT = Path(__file__).resolve().parent.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, section: str, cell: str) -> list[dict]:
    """The entries of ``section`` that ``cell`` reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads."""

    cfg: dict
    traffic: dict
    registry: Registry
    spans: dict
    profile: tracing.Profile | None
    log: list
    untraced_rate: float | None = None     # requests a second outside the stretch


def nvidia_smi() -> str:
    """The card's name, power limit and draw, clocks and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.mem,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def say(*parts) -> None:
    print("siftbench:", *parts, flush=True)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             bench: dict | None = None, registry: Registry | None = None,
             device: torch.device | None = None, program=None,
             t_start: float | None = None) -> dict:
    """Run ``cell_name`` once and return its result (see ``run.py``).
    ``program`` replaces the system under test (the control, a fault)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark() if bench is None else bench
    registry = Registry() if registry is None else registry
    device = torch.device("cuda") if device is None else device
    cell = find_cell(bench, cell_name)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(cell_name)["check"]
    # Built now, so a setting that the configuration's reference has no path
    # for stops the run in set-up; it holds no tensors.
    reference = Reference(cfg, device, registry=registry)
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    on_card = device.type == "cuda"

    phases = {"imports": time.perf_counter() - t_start}
    program = Port(cfg, device) if program is None else program
    views = Views(traffic["views"], h, w, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    phases["program_and_views"] = time.perf_counter() - t_start
    spans = Spans(trace, device)
    flow = registry.request(traffic["request"])(cfg, traffic, views, program, spans, seed)
    flow.warm()
    if on_card:
        torch.cuda.synchronize(device)
    prof = None
    if trace and on_card:
        prof = tracing.start()
        flow.warm()
    spans.clear()
    setup_s = time.perf_counter() - t_start
    phases["warm"] = setup_s
    say("set-up, seconds from the start at the end of each phase:", json.dumps(phases))
    if on_card:
        say("card before the window:", nvidia_smi())

    k = int(traffic["check_requests"])
    rng = np.random.default_rng(derive(seed, "sample"))
    kept: list = []
    lat: list[float] = []
    ends: list[float] = []
    errors: list[str] = []
    profile, last, stretch_end, stop_s = None, None, 0.0, 0.0
    trace_requests = int(traffic["trace_requests"])
    gc.collect()
    gc.disable()
    if prof is not None:
        tracing.mark()
    t0 = time.perf_counter()
    t_end = t0
    deadline = t0 + seconds
    i = 0
    while True:
        ts = time.perf_counter()
        if ts >= deadline:
            break
        slot = len(kept) if len(kept) < k else int(rng.integers(0, i + 1))
        try:
            out = flow.request(i, keep=slot < k)
        except Exception as e:  # a failed request counts; the window goes on
            errors.append(f"request {i}: {type(e).__name__}: {e}")
            flow.log.append({})
            out = None
        t_end = time.perf_counter()
        spans.collect()
        lat.append(t_end - ts)
        ends.append(t_end)
        if out is not None:
            if slot < len(kept):
                kept[slot] = out
            else:
                kept.append(out)
        i += 1
        if prof is not None and i >= trace_requests:
            stretch_end = t_end
            prof.stop()
            stop_s = time.perf_counter() - t_end
            last = i
            profile, prof = prof, None
    gc.enable()
    if prof is not None:                    # the window ended inside the stretch
        stretch_end = t_end
        prof.stop()
        last = i
        profile, prof = prof, None
    window_s = t_end - t0
    if on_card:
        torch.cuda.synchronize(device)
        memory_peak = int(torch.cuda.max_memory_allocated(device))
        say("card after the window:", nvidia_smi())
    else:
        memory_peak = 0
    found = imports.loaded_forbidden()
    if found:
        raise imports.ForbiddenImport(found)
    untraced_rate = None
    if profile is not None:
        profile = tracing.Profile(profile, 0, last, spans.counted(0, last),
                                  stretch_end - t0)
        # The rest of the window ran without the profiler, which slows the
        # host's part of a replayed program (CUPTI records each kernel of a
        # graph as it launches): its rate is the window's own.
        rest_s = window_s - profile.window_s - stop_s
        if rest_s > 0 and i > last:
            untraced_rate = (i - last) / rest_s

    done = i - len(errors)
    result_metrics = {}
    if not trace:
        for m in metrics_of(bench, "end_to_end", cell_name):
            result_metrics[m["name"]] = {"value": e2e_value(m["name"], flow.unit, done,
                                                            window_s, lat, setup_s),
                                         "unit": m["unit"]}
    else:
        reading = Reading(cfg, traffic, registry, spans.ms, profile, flow.log, untraced_rate)
        for m in metrics_of(bench, "per_layer", cell_name):
            v = registry.layer(m["name"]).read(reading)
            if v is not None:
                result_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
    if profile is not None:
        dev_info["busy_s"] = profile.busy_s
        dev_info["window_s"] = profile.window_s
    say("window:", json.dumps({"requests": i, "failed": len(errors), "window_s": window_s,
                               "setup_s": setup_s, "kept": len(kept),
                               "rate_by_quarter": quarter_rates(ends, t0, window_s)}))
    if profile is not None:
        say("traced stretch:", json.dumps({
            "requests": last, "seconds": profile.window_s, "busy_s": profile.busy_s,
            "profiler_stop_s": stop_s, "untraced_rate": untraced_rate}))
    for e in errors[:5]:
        say("failed", e)
    say("summary:", json.dumps(flow.summary(kept)))

    # The judgement, once the window has closed and the peak has been read.
    # The program's captured programs stay (1.0-1.6 GB of the card's 80).
    if on_card:
        torch.cuda.empty_cache()
    numbers = compare.worst(flow.judge(kept, reference)) if kept else {}
    check = {name: [numbers.get(name, math.inf), limit] for name, limit in limits.items()}
    correct = (len(errors) == 0 and bool(kept)
               and all(v <= lim for v, lim in check.values()))
    result = {"correct": correct, "attempted": i, "failed": len(errors),
              "metrics": result_metrics, "device": dev_info}
    if profile is not None:
        result["breakdown"] = profile.breakdown()
    result["check"] = check
    result["numbers"] = numbers
    return result


def quarter_rates(ends: list, t0: float, window_s: float) -> list:
    """Requests completed a second in each quarter of the window."""
    q = window_s / 4
    if q <= 0:
        return []
    counts = np.bincount(np.minimum(((np.asarray(ends) - t0) / q).astype(int), 3), minlength=4)
    return [float(c / q) for c in counts]


def e2e_value(name: str, unit: str, done: int, window_s: float, lat: list, setup_s: float):
    """An end-to-end metric: ``setup_s``, ``<unit>s_per_s`` (requests
    completed over the window) or ``<unit>_ms_p95`` (95th percentile of all
    the window's request times)."""
    if name == "setup_s":
        return setup_s
    if name == f"{unit}s_per_s":
        return done / window_s
    if name == f"{unit}_ms_p95":
        return float(np.percentile(np.asarray(lat) * 1e3, 95))
    raise KeyError(f"{name} is not an end-to-end metric of a {unit} cell")


def print_result(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output
    (``numbers`` holds every number for calibration and is not printed)."""
    result = dict(result)
    result.pop("numbers", None)
    for name, (v, lim) in result["check"].items():
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"check correct = {result['correct']}", file=sys.stderr, flush=True)
    result["check"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                       for k, (v, lim) in result["check"].items()}
    print(json.dumps(result), flush=True)
