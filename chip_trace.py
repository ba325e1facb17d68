"""The port's own trace (``cudasift_tpu_torch.utils.trace``) on the card.

    python3 chip_trace.py check [--frames N]
    python3 chip_trace.py nodes [--tree DIR]
    python3 chip_trace.py cell --workload W --seed N --seconds S --trace 0|1 --hook 0|1

``check``: a 1920x1080 frame at the benchmark's settings, N calls in a
closed loop with tracing off, then N with it on: the host's time in a call
and a frame's time both ways; each program's graph nodes by type; the
stages a frame (totals over the traced calls, and self times) against the
calls' replay intervals (``jit.call`` events from the end of the copy-in to
the start of the clones); the host spans; and the off and traced graphs
replayed back to back in turns, device time a replay. One JSON line.

``nodes``: the nodes of the extraction body at the same settings captured
by hand into a kept graph, for the package of ``DIR`` (default: this tree),
counted by this tree's ``graph_nodes``. One JSON line.

``cell``: one run of a benchmark cell (``siftbench/run.py``'s arguments)
with, under ``--hook 1``, the port's tracing on from before the first warm
request, cleared with the run's own spans, and its snapshot handed to the
per-layer readers as ``reading.program``; the readers of the port's trace
that ``BENCHMARK.json`` does not list are read too. The result line as
``siftbench/run.py`` prints it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The readers of the port's trace beyond BENCHMARK.json: (moves, cells).
FRAMES = ["1080p-frames", "960p-frames", "960p-upscale"]
HOOKED = {
    "upscale_ms.upscale": ("frames_per_s", ["960p-upscale"]),
    "pyramid_ms.frames": ("frames_per_s", FRAMES),
    "compact_ms.frames": ("frames_per_s", FRAMES),
    "glue_ms.frames": ("frames_per_s", FRAMES),
    "merge_ms.frames": ("frames_per_s", FRAMES),
    "ransac_score_ms.pairs": ("pairs_per_s", ["1080p-pairs"]),
    "host_ms.frames": ("frames_per_s", FRAMES),
    "replay_gap_ms.frames": ("frames_per_s", FRAMES),
    "idle_in_program.frames": ("frames_per_s", FRAMES),
    "idle_in_program.track": ("frames_per_s", ["1080p-track"]),
}


def frame_and_params(device):
    import torch

    import cudasift_tpu_torch as ct
    from cudasift_tpu_torch.utils import synth

    cfg = json.loads((ROOT / "siftbench" / "configs" / "cudasift-1920x1080.json").read_text())
    img = torch.as_tensor(synth.make_leaves_image(1080, 1920, 0), device=device)
    return img, ct.SiftParams(**cfg["sift"])


def check(frames: int) -> dict:
    import torch

    import cudasift_tpu_torch as ct
    from cudasift_tpu_torch import pipeline
    from cudasift_tpu_torch.utils import trace

    dev = torch.device("cuda")
    img, params = frame_and_params(dev)

    def loop():
        """(host ms of a call, ms a frame) over a closed loop that reads
        each frame's count back."""
        calls, t_loop = [], time.perf_counter()
        for _ in range(frames):
            t0 = time.perf_counter()
            d = ct.extract_sift(img, params)
            calls.append(time.perf_counter() - t0)
            int(d.num_pts)
        return 1e3 * statistics.mean(calls), 1e3 * (time.perf_counter() - t_loop) / frames

    for _ in range(3):
        int(ct.extract_sift(img, params).num_pts)
    off = loop()
    trace.enable()
    for _ in range(3):
        int(ct.extract_sift(img, params).num_pts)
    trace.clear()
    on = loop()
    snap = trace.snapshot()
    trace.disable()

    def replay_ms(graph, n=200):
        """Device ms of one replay of ``graph``, over ``n`` back to back."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    programs = {p.trace is not None: p for p in pipeline._extract_sift_jit.programs.values()}
    replays = {"off": [], "traced": []}
    for _ in range(3):                    # in turns: off, traced, traced, off
        for name, graph in (("off", programs[False].graph), ("traced", programs[True].graph),
                            ("traced", programs[True].twin[0]), ("off", programs[False].graph)):
            replays[name].append(replay_ms(graph))
    calls = [c for c in snap["calls"] if c["function"] == "_extract_sift_jit"]
    st = snap["stages"]
    per = st["extract.pyramid"]["count"]
    top = sum(st[k]["ms"] for k in ("extract.pyramid", "extract.octave", "extract.merge"))
    last = snap["last_stages"]["_extract_sift_jit"]
    kids: dict[str, list] = {}
    for s in snap["spans"]:
        kids.setdefault(s["name"], []).append((s["end_ns"] - s["start_ns"]) / 1e6)
    return {
        "device": torch.cuda.get_device_name(dev), "frames": frames, "reads": len(calls),
        "nodes": {("traced" if p["traced"] else "off"): p["nodes"] for p in snap["programs"]
                  if p["function"] == "_extract_sift_jit"},
        "stage_count": {k: v["count"] for k, v in st.items()},
        "stage_ms_a_frame": {k: v["ms"] / per for k, v in st.items()},
        "self_ms_a_frame": {k: v["self_ms"] / per for k, v in st.items()},
        "plain_ms_a_frame": sum(st[k][w] for k, w in (
            ("extract.pyramid", "ms"), ("extract.compact", "ms"), ("extract.octave", "self_ms"),
            ("extract.merge", "ms"))) / per,
        "stages_over_replays": top / sum(c["replay_ms"] for c in calls),
        "last_call": {"stages_ms": sum(s["end_ms"] - s["start_ms"] for s in last
                                       if s["parent"] == -1),
                      "replay_ms": calls[-1]["replay_ms"]},
        "call_ms": {k: statistics.mean(c[k] for c in calls)
                    for k in ("copy_in_ms", "replay_ms", "clone_ms")},
        "gap_ms": statistics.mean(c["gap_ms"] for c in calls if c["gap_ms"] is not None),
        "host_span_ms": {k: statistics.mean(v) for k, v in kids.items()},
        "host_call_ms": {"off": off[0], "on": on[0]},
        "frame_ms": {"off": off[1], "on": on[1]},
        "graph_replay_ms": replays,
        "counters": snap["counters"],
    }


def nodes(tree: Path) -> dict:
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_trace_graph_nodes", ROOT / "cudasift_tpu_torch" / "utils" / "trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path.insert(0, str(tree))
    from cudasift_tpu_torch import pipeline

    img, params = frame_and_params(torch.device("cuda"))
    assert Path(pipeline.__file__).resolve().is_relative_to(tree.resolve()), pipeline.__file__
    pipeline._extract(img, params)            # builds and loads the kernels
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        pipeline._extract(img, params)
    own = None
    if tree.resolve() == ROOT:
        import cudasift_tpu_torch as ct

        ct.extract_sift(img, params)
        own = next(iter(pipeline._extract_sift_jit.programs.values())).nodes
    return {"tree": str(tree), "by_hand": mod.graph_nodes(graph.raw_cuda_graph()),
            "program": own}


def with_hook(bench: dict, workload: str) -> dict:
    """Turn the port's tracing on, clear it with the run's own spans and hand
    its snapshot to the readers; returns ``bench`` with the readers of the
    port's trace that ``workload`` reports."""
    from siftbench import flows, harness
    from siftbench.registry import Registry

    from cudasift_tpu_torch.utils import trace

    reg = Registry()
    extra = []
    for name, (moves, cells) in HOOKED.items():
        if workload in cells:
            m = reg.layer(name)
            extra.append({"name": name, "unit": m.UNIT, "better": "lower", "source": m.SOURCE,
                          "layer": m.LAYER, "moves": moves, "workloads": cells})
    trace.enable()
    clear = flows.Spans.clear

    def clear_both(self):
        clear(self)
        trace.clear()

    class Reading(harness.Reading):
        def __post_init__(self):
            self.program = trace.snapshot()

    flows.Spans.clear = clear_both
    harness.Reading = Reading
    return dict(bench, per_layer=bench["per_layer"] + extra)


def cell(args) -> int:
    import torch

    from siftbench import harness

    torch.set_num_threads(1)
    bench = harness.load_benchmark(ROOT)
    if args.hook:
        bench = with_hook(bench, args.workload)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              bench=bench, t_start=T_START)
    result["hook"] = bool(args.hook)
    harness.print_result(result)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("check")
    c.add_argument("--frames", type=int, default=200)
    n = sub.add_parser("nodes")
    n.add_argument("--tree", type=Path, default=ROOT)
    r = sub.add_parser("cell")
    r.add_argument("--workload", required=True)
    r.add_argument("--seed", type=int, required=True)
    r.add_argument("--seconds", type=float, required=True)
    r.add_argument("--trace", type=int, choices=(0, 1), default=0)
    r.add_argument("--hook", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if args.mode == "cell":
        return cell(args)
    print(json.dumps(check(args.frames) if args.mode == "check" else nodes(args.tree)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
