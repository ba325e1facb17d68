#!/usr/bin/env python3
"""The kernel table of the PyTorch port (``cudasift_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles every kernel source of ``utils.build.Kernel.instances``
   (one nvcc per source, all at once) and the C++ host codec (g++).
3. The launch floor: an empty kernel replayed from a CUDA graph at one block
   (its row, timed first) and at the grids of K2, K6, RANSAC's scoring and
   the weighted refit (``floor_ms`` on every row).
4. The inputs: the blocks frame (``synth.make_test_image``), the 1920x1080
   dead-leaves pair (``synth.make_leaves_image``, frame B warped by a known
   homography) and the eager demo flow on it (two extractions,
   ``match_sift_data``, ``find_homography`` at 10000 loops) fused with K3's
   ``shift`` and ``fast`` samplers and split (K6, K7, K8): the ``shift``
   flow's sets, hypotheses and refits feed the matcher, RANSAC-scoring and
   refit rows, each path's launches ``flow_launches`` of its kernels.
5. One row a launcher (K3 twice: ``shift`` and ``fast``), 25 in all: the
   kernel against its plain PyTorch version at the row's tolerance, on the
   row's arguments and at every main-path shape the row times (the leaves
   octaves, the flow's sets and refits); a row that fails stops the run.
   Then timed with CUDA events: a single call (``ms``), 100 calls replayed
   from one CUDA graph (``graph_ms``, device time without the host's
   dispatch), the plain version (``plain_ms``), the least time the card
   could take (``bound_ms``, by ``siftbench/counts/peaks.py``) and, where
   one PyTorch call computes the same function, that call (``library_ms``,
   ``library_graph_ms``); some rows add 100 calls back to back
   (``loop_ms``) and timings at other shapes.

Correctness on the card is the card tests' (``tests/test_torch_gpu.py``);
end-to-end and per-layer time is the benchmark's (``siftbench/``). To
compare two trees, run this script in each (the other unpacked with ``git
archive``) in turns on one card and compare the ``kernels`` lines row by
row. Prints one JSON line with the rows, then as its last line
``{"ok": true, "device": {...}}``; a failed check raises and exits non-zero
without that line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

import cudasift_tpu_torch as ct
from cudasift_tpu_torch import parallel
from cudasift_tpu_torch.ops import convolve, detect, homography
from cudasift_tpu_torch.ops import match as match_plain
from cudasift_tpu_torch.ops import orient as orient_plain
from cudasift_tpu_torch.ops.cuda import (FUSED_PATH, SPLIT_PATH, acquire, compact, descriptor,
                                         dog, lstsq, match, orient, orient_desc, probes, ransac,
                                         refine, scale_up)
from cudasift_tpu_torch.pipeline import _compact
from cudasift_tpu_torch.utils import jit, native, synth, trace
from cudasift_tpu_torch.utils.build import Kernel, build
from cudasift_tpu_torch.utils.timers import time_ms, time_ms_graph, time_ms_loop
from siftbench.counts.peaks import bound_s

T_START = time.perf_counter()
H, W = 1080, 1920
SEED = 0
PARAMS = ct.SiftParams(num_octaves=5, init_blur=1.0, thresh=3.0, max_pts=32768)
# The launch floor's grids (blocks, threads): one block, and those of the
# launch-bound kernels, which no kernel of that grid can beat: K2 (a warp a
# block) and K6 (four slots a block of 128) at octave 0's 5120 slots;
# RANSAC's scoring (10000 hypotheses, 512 a block, x 32768 / 256 point
# splits); the refit (a cluster of 8 blocks of 1024, one weighting).
FLOOR_GRIDS = {"one_block": (1, 32), "refine": (5120 // 32, 32), "orient": (5120 // 4, 128),
               "ransac_score": (-(-10000 // 512) * (32768 // 256), 128), "lstsq8": (8, 1024)}
# The demo flow's paths on the leaves pair: fused with K3's two samplers, and split.
FLOW_PATHS = {"shift": {}, "fast": dict(fast_gradients=True),
              "split": dict(use_fused=False, use_pallas_compact=True)}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:.1f} s] {msg}", flush=True)


def keypoint_square(scale, reach: float, per_scale: float) -> float:
    """Bytes of the image squares that live keypoints read: side
    2 * ceil(per_scale * scale + reach) + 1 pixels each."""
    side = 2 * torch.ceil(per_scale * scale + reach) + 1
    return float((side * side).sum()) * 4


def near_tie_gap(a, b, got, ref) -> float:
    """The largest gap between the float64 scores of two matchers' picks
    (columns of ``b`` for rows of ``a``) where they differ, else 0."""
    rows = (got != ref).nonzero()[:, 0]
    picks = [(a[rows].double() * b[p[rows].long()].double()).sum(dim=1) for p in (got, ref)]
    return float((picks[0] - picks[1]).abs().max()) if len(rows) else 0.0


@dataclasses.dataclass
class Row:
    """One row of the table: ``fn(*args)`` launches ``kernel`` once,
    ``check(out, plain(*args))`` raises past the row's tolerance and returns
    the largest absolute error, ``bound`` is ``bound_s``'s (seconds, what
    sets it); ``extras(record)`` adds the row's other timings, and ``also``
    holds the (arguments, check) pairs at the other main-path shapes that
    they time, each checked against plain before any timing."""

    name: str
    kernel: Kernel
    fn: Callable
    args: tuple
    plain: Callable
    check: Callable
    bound: tuple
    library: Callable | None = None
    library_args: tuple = ()
    loop: bool = False              # loop_ms (and library_loop_ms): 100 calls back to back
    plain_graph: bool = False       # plain_graph_ms
    plain_timing: tuple = (20, 3)   # the plain version's (iters, warmup)
    extras: Callable | None = None
    also: tuple = ()


def run_row(row: Row, floors: dict, flow: dict) -> dict:
    """Check ``row`` and time it; returns its record."""
    before = row.kernel.launches
    out = row.fn(*row.args)
    torch.cuda.synchronize()
    launches = row.kernel.launches - before
    err = row.check(out, row.plain(*row.args))
    also = [check(row.fn(*args), row.plain(*args)) for args, check in row.also]
    lib = row.library
    rec = dict(name=row.name, route="cuda", source=row.kernel.source_path,
               replaces=row.kernel.replaces, launches=launches, flow_launches=flow.get(row.name),
               max_abs_err=err, ms=time_ms(row.fn, *row.args),
               graph_ms=time_ms_graph(row.fn, *row.args),
               plain_ms=time_ms(row.plain, *row.args, iters=row.plain_timing[0],
                                warmup=row.plain_timing[1]),
               bound_ms=row.bound[0] * 1e3, bound_by=row.bound[1],
               library_ms=None if lib is None else time_ms(lib, *row.library_args),
               floor_ms=floors.get(row.name, floors["one_block"]))
    if lib is not None:
        rec["library_graph_ms"] = time_ms_graph(lib, *row.library_args)
    if row.loop:
        rec["loop_ms"] = time_ms_loop(row.fn, *row.args, n=100)
        if lib is not None:
            rec["library_loop_ms"] = time_ms_loop(lib, *row.library_args, n=100)
    if row.plain_graph:
        rec["plain_graph_ms"] = time_ms_graph(row.plain, *row.args)
    if row.extras is not None:
        rec.update(row.extras(rec))
    at = f" ({max(also):.3g} at {len(also)} other shapes)" if also else ""
    log(f"{row.name}: max abs err {err:.3g}{at}, single {rec['ms']:.4f} ms, graph-replayed "
        f"{rec['graph_ms']:.5f} ms, plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} "
        f"ms ({rec['bound_by']}), launches a call {launches}, in the flow {rec['flow_launches']}")
    return rec


def build_all() -> None:
    """Every kernel source of the process and the C++ host codec, at once."""
    sources = sorted({(k.source, k.flags) for k in Kernel.instances})
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        codec = pool.submit(native.have_native)
        libs = list(pool.map(lambda sf: build(*sf), sources))
        require(codec.result(), "the C++ host codec did not build (no g++)")
    for k in Kernel.instances:
        k.load()
    log(f"built {[p.name for p in libs]} + host codec")


def octave_inputs(base: torch.Tensor, o: int, params) -> dict:
    """K1's, K2's and K3's arguments at octave ``o`` of a frame, fed as the
    fused path feeds them (K1 and K2 the kernels, the compaction plain)."""
    cap = params.candidate_capacity(*base.shape, o)
    k1 = (base, params.laplace_kernels[o], params.thresh, params.edge_limit)
    dog_o, mask = dog.dog_and_mask(*k1)
    idx, count = detect.compact_mask(mask, cap)
    k2 = (dog_o, idx, count, params.edge_limit, params.lowest_scale_effective / 2 ** o)
    c = refine.refine_candidates(*k2)
    k3 = (base, c.xpos, c.ypos, torch.where(c.valid, c.scale, 1.0), c.valid)
    return dict(k1=k1, k2=k2, k3=k3, cap=cap, mask=mask, refined=c)


def eager_flow(leaf: list, params) -> tuple:
    """The demo flow on the leaves pair dispatched from the host: (its two
    SiftData, the launches of every kernel, the arguments of each RANSAC
    scoring call and of each refit)."""
    seen = {"score": [], "refit": []}

    def recorded(calls: list, fn):
        def call(*args):
            calls.append(args)
            return fn(*args)
        return call

    torch.cuda.synchronize()
    before = {k: k.launches for k in Kernel.instances}
    homography.inlier_counts = recorded(seen["score"], ransac.inlier_counts)
    homography.weighted_lstsq8 = recorded(seen["refit"], lstsq.weighted_lstsq8)
    try:
        with jit.disable_graphs():
            la, lb = [ct.extract_sift(f, params) for f in leaf]
            ct.find_homography(ct.match_sift_data(la, lb),
                               torch.Generator(device=leaf[0].device).manual_seed(SEED),
                               num_loops=10000, min_score=0.0, max_ambiguity=0.80, thresh=5.0)
        torch.cuda.synchronize()
    finally:
        homography.inlier_counts = ransac.inlier_counts
        homography.weighted_lstsq8 = lstsq.weighted_lstsq8
    return la, lb, {k: k.launches - before[k] for k in Kernel.instances}, seen


def produce(dev: torch.device) -> SimpleNamespace:
    """The rows' inputs (module docstring, step 4)."""
    params = PARAMS
    h_true = synth.known_homography(H, W)
    leaves_a = synth.make_leaves_image(H, W, SEED)
    leaf = [torch.as_tensor(f, device=dev) for f in (leaves_a, synth.warp_image(leaves_a, h_true))]
    bases = [convolve.low_pass(leaf[0], params.init_blur)]
    for _ in range(params.num_octaves - 1):
        bases.append(convolve.scale_down(bases[-1]))
    leaves = [octave_inputs(b.contiguous(), o, params) for o, b in enumerate(bases)]
    blocks = torch.as_tensor(synth.make_test_image(H, W, SEED), device=dev)
    block0 = octave_inputs(convolve.low_pass(blocks, params.init_blur).contiguous(), 0, params)

    runs = {path: eager_flow(leaf, dataclasses.replace(params, **kw))
            for path, kw in FLOW_PATHS.items()}
    la, lb, shift, seen = runs["shift"]
    fast, split = runs["fast"][2], runs["split"][2]
    require(all(shift[k] for k in FUSED_PATH) and fast[orient_desc.KERNEL]
            and all(split[k] for k in SPLIT_PATH) and not split[orient_desc.KERNEL]
            and not any(shift[k] for k in SPLIT_PATH if k not in FUSED_PATH),
            f"a flow missed its path's kernels or launched the other path's: "
            f"{ {p: {k.name: n for k, n in r[2].items() if n} for p, r in runs.items()} }")
    require([s[0].shape[0] for s in seen["score"]] == [10000, 1],
            f"RANSAC scored {[s[0].shape[0] for s in seen['score']]} hypotheses, not [10000, 1]")
    require([r[2].shape[0] for r in seen["refit"]] == [1] * 4,
            f"the refit was called with {[r[2].shape[0] for r in seen['refit']]} weightings")
    # Launches of one flow (two extractions, a match and RANSAC): the shift
    # flow's for its kernels, the fast and split flows' for theirs.
    flow = {k.name: shift[k] for k in FUSED_PATH + (ransac.SCORE_KERNEL, lstsq.KERNEL)}
    flow["orient_desc_fast"] = fast[orient_desc.KERNEL]
    flow.update({k.name: split[k] for k in SPLIT_PATH if k not in FUSED_PATH})
    log(f"the eager leaves flows: {int(la.num_pts)} / {int(lb.num_pts)} points, "
        f"launches {flow}")

    # Unit sets for the matchers: 4096 x 4096 with n2 a mask of 4001, and
    # 16384 columns for the sharded matcher.
    rng = np.random.default_rng(SEED)

    count = functools.partial(torch.tensor, dtype=torch.int32, device=dev)

    def unit_rows(n):
        u = rng.standard_normal((n, 128)).astype(np.float32)
        return torch.as_tensor(u / np.linalg.norm(u, axis=1, keepdims=True), device=dev)

    return SimpleNamespace(
        dev=dev, leaves=leaves, block0=block0, flow=flow,
        lsets=(la.data, lb.data, la.num_pts, lb.num_pts), scored=seen["score"],
        refits=seen["refit"], units=(unit_rows(4096), unit_rows(4096), count(4096), count(4001)),
        wide=(unit_rows(16384), count(16384)))


def floor_record(dev: torch.device) -> tuple[dict, dict]:
    """The launch floor's row, the first timing on the card, and the floor at
    each grid of ``FLOOR_GRIDS`` (one block: the row's own ``graph_ms``)."""
    rec = run_row(Row("probe_launch_floor", probes.LAUNCH_FLOOR, probes.launch_floor, (dev,),
                      probes.launch_floor_plain, lambda out, ref: 0.0, bound_s(0, 0)),
                  {"one_block": None}, {})
    floors = {name: rec["graph_ms"] if name == "one_block" else
              time_ms_graph(probes.launch_floor, dev, *grid) for name, grid in FLOOR_GRIDS.items()}
    log(f"launch floor (empty kernel, graph-replayed): {json.dumps(floors)} ms")
    rec.update(floor_ms=floors["one_block"], floor_by_grid={
        name: dict(blocks=g[0], threads=g[1], graph_ms=floors[name])
        for name, g in FLOOR_GRIDS.items()})
    return rec, floors


def pyramid_rows(inp) -> list[Row]:
    """K1 and K2 on octave 0 of the blocks frame, and at the five octaves of
    leaves A that ``flow_graph_ms`` times; K8 on octave 0 of leaves A."""
    b0, l0 = inp.block0, inp.leaves[0]
    hw = H * W

    def k1_check(out, ref):     # no tolerance: the kernel keeps the plain order of operations
        require(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
                f"K1 differs: dog max abs {float((out[0] - ref[0]).abs().max())}, "
                f"{int((out[1] != ref[1]).sum())} mask entries")
        return 0.0

    def k2_check(out, ref):     # every field equal
        require(all(torch.equal(getattr(out, f), getattr(ref, f)) for f in
                    ("xpos", "ypos", "scale", "sharpness", "edgeness", "valid")),
                f"K2 differs from plain in {tuple(out.xpos.shape)} slots")
        return 0.0

    def k8_check(out, ref):     # indices, count and total equal
        require(all(torch.equal(a, b) for a, b in zip(out, ref)), "K8 differs from plain")
        return 0.0

    cap0, ncand = b0["cap"], int(b0["k2"][2])
    mask = l0["mask"]
    nonzero_static = lambda f: torch.nonzero_static(f, size=cap0, fill_value=0)  # noqa: E731
    return [
        # Bound: the base and taps in, 7 DoG planes (f32) and 5 mask planes
        # (bool) out; a pixel 8 blurs of two 9-tap passes (17 operations
        # each), 7 differences, 5 scales of 26 comparisons and an edge test
        # of about 10.
        Row("dog", dog.KERNEL, dog.dog_and_mask, b0["k1"], dog.dog_and_mask_plain, k1_check,
            bound_s(hw * (8 * 2 * 17 + 7 + 5 * (26 + 10)),
                    4 * hw + 4 * b0["k1"][1].size + 7 * 4 * hw + 5 * hw),
            loop=True, extras=lambda rec: dict(
                leaves_graph_ms=time_ms_graph(dog.dog_and_mask, *l0["k1"]), flow_graph_ms=2 * sum(
                    time_ms_graph(dog.dog_and_mask, *oc["k1"]) for oc in inp.leaves)),
            also=tuple((oc["k1"], k1_check) for oc in inp.leaves)),
        # Bound: the indices and count in, a 3x3x3 DoG cube a candidate, five
        # f32 fields and the flag out for every slot; about 200 operations a
        # candidate (gradient, Hessian, 3x3 solve, tests).
        Row("refine", refine.KERNEL, refine.refine_candidates, b0["k2"],
            detect.refine_candidates, k2_check,
            bound_s(200 * ncand, 4 * cap0 + 4 + 27 * 4 * ncand + 5 * 4 * cap0 + cap0),
            extras=lambda rec: dict(flow_graph_ms=2 * sum(
                time_ms_graph(refine.refine_candidates, *oc["k2"]) for oc in inp.leaves)),
            also=tuple((oc["k2"], k2_check) for oc in inp.leaves)),
        # Bound: the mask in, indices, count and total out; an operation an
        # entry. Library: torch.nonzero_static of the flat mask into the
        # capacity; beside it torch.nonzero (uncapped; it waits for the host).
        Row("compact", compact.KERNEL, compact.compact_mask, (mask, cap0),
            lambda m, c: detect.compact_mask(m, c, with_total=True), k8_check,
            bound_s(mask.numel(), mask.numel() + 4 * cap0 + 8),
            library=nonzero_static, library_args=(mask.reshape(-1),), loop=True,
            extras=lambda rec: dict(nonzero_ms=time_ms(torch.nonzero, mask.reshape(-1)))),
    ]


def k3_bound(xpos, scale, valid, has2) -> tuple:
    """K3's bound: positions, scales and the live mask in, each live
    keypoint's image square (reach 7.96 * scale + 2.5 px) read once, both
    descriptor tables and the orientations out for every slot; about 6000
    operations for an orientation and 256 grid samples of about 60 for a
    descriptor."""
    n, nl = xpos.shape[0], int(valid.sum())
    ndesc = nl + int((has2 & valid).sum())
    return bound_s(6000 * nl + 256 * 60 * ndesc,
                   13 * n + keypoint_square(scale[valid], 2.5, 7.96) + 2 * 128 * 4 * n + 9 * n)


def keypoint_rows(inp) -> list[Row]:
    """K3 on the blocks frame's octave-0 keypoints (both samplers) and at
    the leaves octaves its extras time, K6 and K7 on leaves A's octave 0,
    front-packed as the split path packs them."""
    k3 = inp.block0["k3"]

    def k3_check(k3_args):
        # Orientations: median error < 0.2 deg, >= 90% within 2 deg, has2 on
        # >= 90%; descriptors, where orientations agree (>= 90%): a row's
        # max-abs error median < 4e-3 and max < 2e-2, unit length.
        live = k3_args[4]
        nlive = int(live.sum())
        require(nlive > 0, f"K3 has no live keypoints in {tuple(k3_args[0].shape)}")

        def check(out, ref):
            dori = (out[2] - ref[2]).abs()[live]
            dori = torch.minimum(dori, 360.0 - dori)
            require(float(dori.median()) < 0.2 and float((dori < 2.0).float().mean()) >= 0.9,
                    f"K3 orientations differ: median {float(dori.median())}")
            agree2 = float((out[4] == ref[4])[live].float().mean())
            require(agree2 >= 0.9, f"K3 has2 agrees on {agree2}")
            same = live & ((out[2] - ref[2]).abs() < 1e-3)
            require(int(same.sum()) >= 0.9 * nlive, "K3 orientations agree on < 90%")
            rowerr = (out[0] - ref[0]).abs().max(dim=1).values[same]
            require(float(rowerr.median()) < 4e-3 and float(rowerr.max()) < 2e-2,
                    f"K3 descriptors differ: median {float(rowerr.median())}, max "
                    f"{float(rowerr.max())}")
            require(bool(((out[0][live].norm(dim=1) - 1.0).abs() < 1e-4).all()),
                    "K3 descriptors are not unit length")
            return float(rowerr.max())

        return check

    leaves0 = inp.leaves[0]["k3"]
    has2_leaves = orient_desc.orient_and_describe(*leaves0, "shift")[4]

    def k3_row(name, mode):
        octs = inp.leaves if mode == "shift" else inp.leaves[:1]

        def extras(rec):
            times = [time_ms_graph(orient_desc.orient_and_describe, *oc["k3"], mode)
                     for oc in octs]
            out = {"leaves": dict(live=int(leaves0[4].sum()), graph_ms=times[0],
                                  bound_ms=k3_bound(leaves0[1], leaves0[3], leaves0[4],
                                                    has2_leaves)[0] * 1e3)}
            if mode == "shift":
                out["flow_graph_ms"] = 2 * sum(times)
            return out

        has2 = orient_desc.orient_and_describe(*k3, mode)[4]
        return Row(name, orient_desc.KERNEL, orient_desc.orient_and_describe, (*k3, mode),
                   orient_desc.orient_and_describe_plain, k3_check(k3),
                   k3_bound(k3[1], k3[3], k3[4], has2), plain_timing=(5, 3), extras=extras,
                   also=tuple(((*oc["k3"], mode), k3_check(oc["k3"])) for oc in octs))

    l0 = inp.leaves[0]
    c, cap0 = l0["refined"], l0["cap"]
    f0, live0, _ = _compact({"xpos": c.xpos, "ypos": c.ypos, "scale": c.scale}, c.valid, cap0)
    nl0 = int(live0)
    sc0 = torch.where(torch.arange(cap0, device=inp.dev) < live0, f0["scale"], 1.0)
    k6 = (l0["k1"][0], f0["xpos"], f0["ypos"], sc0, live0)

    def k6_check(out, ref):
        # Histograms at rtol 1e-5 (atol 1e-6: only the order of a bin's sum
        # differs), zeros past the count, the peaks those of histogram_peaks
        # on the kernel's own histograms, primary peaks within 1e-3 deg of
        # plain on >= 99% of the live slots.
        kh, kp1, kp2, kh2 = out
        require(nl0 > 0 and torch.allclose(kh, ref[0], rtol=1e-5, atol=1e-6),
                f"K6 histograms differ: max abs {float((kh - ref[0]).abs().max())}")
        require(not any(t[nl0:].any() for t in out), "K6 wrote past the count")
        own = orient_plain.histogram_peaks(kh)
        require(all(torch.equal(a[:nl0], b[:nl0]) for a, b in zip((kp1, kp2, kh2), own)),
                "K6 peaks differ from histogram_peaks of its histograms")
        dp = (kp1 - ref[1]).abs()[:nl0]
        share = float((torch.minimum(dp, 360.0 - dp) < 1e-3).float().mean())
        require(share >= 0.99, f"K6 peaks agree on {share}")
        return float((kh - ref[0]).abs().max())

    k7 = k6[:4] + (orient.orientation_peaks(*k6)[1], live0)

    def k7_check(out, ref):     # max abs <= 1e-5, unit length, zeros past the count
        err = float((out - ref).abs().max())
        require(err <= 1e-5, f"K7 descriptors differ: max abs {err}")
        require(bool(((out[:nl0].norm(dim=1) - 1.0).abs() < 1e-4).all()),
                "K7 descriptors are not unit length")
        require(not out[nl0:].any(), "K7 wrote past the count")
        return err

    return [
        k3_row("orient_desc", "shift"), k3_row("orient_desc_fast", "fast"),
        # Bound: positions, scales and the count in, each live keypoint's
        # 17 x 17 square, the (slots, 32) histograms and the peaks out; about
        # 40 operations for each of 121 samples a live keypoint.
        Row("orient", orient.KERNEL, orient.orientation_peaks, k6,
            orient.orientation_peaks_plain, k6_check,
            bound_s(nl0 * 121 * 40, 12 * cap0 + 4 + nl0 * 17 * 17 * 4 + cap0 * (32 * 4 + 9)),
            extras=lambda rec: dict(
                hist_graph_ms=time_ms_graph(orient.orientation_histograms, *k6))),
        # Bound: positions, scales, orientations and the count in, each live
        # keypoint's square (reach 7.96 * scale + 2.5 px), the descriptors
        # out; 256 samples of about 70 operations a live keypoint.
        Row("descriptor", descriptor.KERNEL, descriptor.extract_descriptors, k7,
            descriptor.extract_descriptors_plain, k7_check,
            bound_s(nl0 * 256 * 70, 16 * cap0 + 4 + keypoint_square(sc0[:nl0], 2.5, 7.96)
                    + cap0 * 128 * 4)),
    ]


def matcher_rows(inp) -> list[Row]:
    """K4 and K5 at 4096 x 4096 (n2 4001), and on the leaves flow's sets
    (32768 slots) that their extras time."""
    d1, d2, n1, n2 = args = inp.units
    lsets = inp.lsets
    ln1, ln2, cap = int(lsets[2]), int(lsets[3]), lsets[0].shape[0]
    live_bytes, live_ops = (ln1 + ln2) * 128 * 4, 3 * 2.0 * ln1 * ln2 * 128
    # Library: torch.mm and torch.topk(k=2), two calls (no one call gives a top-2 match).
    top2 = lambda a, b, n: torch.topk(torch.mm(a, b[:n].t()), 2, dim=1)  # noqa: E731
    leaves_library_ms = time_ms_loop(top2, lsets[0][:ln1], lsets[1], ln2, n=50)

    def k4_check(out, ref):     # indices equal; scores at rtol 1e-5 / atol 1e-6 (3xTF32)
        require(torch.equal(out[2], ref[2]), f"K4 indices differ on "
                                             f"{int((out[2] != ref[2]).sum())} rows")
        require(int(out[2].max()) < 4001, "K4 matched a masked column")
        require(torch.allclose(out[0], ref[0], rtol=1e-5, atol=1e-6), "K4 scores differ")
        return float((out[0] - ref[0]).abs().max())

    def k4_extras(rec):
        # The sharded matcher on a mesh of the card four times, on the leaves
        # flow's sets and 4096 x 16384 unit sets, against one K4 call.
        mesh = parallel.Mesh((inp.dev,) * 4)
        sharded = {}
        for what, s in (("leaves", lsets), ("4096x16384", (d1, inp.wide[0], n1, inp.wide[1]))):
            amb = parallel.match_descriptors_sharded(*s, mesh)[1]
            ref = match.match_descriptors(*s)[1]
            sharded[what] = dict(
                ambiguity_max_rel_err=float(((amb - ref).abs() / ref.abs().clamp(min=1e-30)).max()),
                ambiguity_bits_equal=bool(torch.equal(amb, ref)),
                loop_ms=time_ms_loop(parallel.match_descriptors_sharded, *s, mesh, n=20),
                single_loop_ms=time_ms_loop(match.match_descriptors, *s, n=20))
        second = match.match_top2(*args)[1] - match_plain.match_top2(*args)[1]
        return dict(
            bound_f32_ms=bound_s(2.0 * 4096 * 4001 * 128, 2 * 4096 * 128 * 4 + 3 * 4096 * 4)[0]
            * 1e3,
            second_max_abs_err=float(second.abs().max()),
            leaves=dict(loop_ms=time_ms_loop(match.match_descriptors, *lsets, n=50),
                        library_loop_ms=leaves_library_ms,
                        bound_ms=bound_s(live_ops, live_bytes + 3 * cap * 4, "tf32")[0] * 1e3),
            flow_graph_ms=time_ms_graph(match.match_descriptors, *lsets, n=20), sharded=sharded)

    def k4_leaves_check(out, ref):
        # Scores at rtol 1e-5 / atol 1e-6; indices equal but at near-ties: the
        # float64 scores of the two picks within 1e-6 (each float32 sum errs
        # by up to about 3e-7).
        err = float((out[0] - ref[0]).abs().max())
        require(torch.allclose(out[0], ref[0], rtol=1e-5, atol=1e-6),
                f"K4 scores on the flow's sets differ: max abs {err}")
        gap = near_tie_gap(lsets[0], lsets[1], out[2], ref[2])
        require(gap <= 1e-6, f"K4 picks on the flow's sets differ beyond a near-tie: {gap}")
        return err

    def k5_check(out, ref):
        # Columns equal but where two bfloat16x3 scores tie within the
        # summation order's rounding (>= 99.9%), scores within 1e-6 there.
        agree = out[1] == ref[1]
        err, share = float((out[0] - ref[0]).abs()[agree].max()), float(agree.float().mean())
        require(share >= 0.999 and err <= 1e-6,
                f"K5 sweep differs: columns agree on {share}, score err {err}")
        return err

    chunks = lambda n: -(-n // match_plain.SWEEP_CHUNK)  # noqa: E731
    return [
        # Bound: both sets in, three (N1,) outputs; three TF32 products of
        # 4096 x 4001 x 128 multiply-adds (bound_f32_ms: one float32 product).
        Row("match", match.KERNEL, match.match_descriptors, args, match_plain.match_descriptors,
            k4_check, bound_s(3 * 2.0 * 4096 * 4001 * 128, 2 * 4096 * 128 * 4 + 3 * 4096 * 4,
                              "tf32"),
            library=top2, library_args=(d1, d2, 4001), loop=True, extras=k4_extras,
            also=((lsets, k4_leaves_check),)),
        # Bound: both sets in, the (N1, 32) candidates out; three bfloat16
        # products of 4096 x 4001 x 128 multiply-adds.
        Row("match_sweep", match.SWEEP_KERNEL, match.sweep_candidates, args,
            match_plain.sweep_candidates, k5_check,
            bound_s(3 * 2.0 * 4096 * 4001 * 128, 2 * 4096 * 128 * 4 + 4096 * 2 * chunks(4096) * 8,
                    "bf16"),
            library=top2, library_args=(d1, d2, 4001), loop=True,
            extras=lambda rec: dict(leaves=dict(
                loop_ms=time_ms_loop(match.sweep_candidates, *lsets, n=50),
                library_loop_ms=leaves_library_ms,
                bound_ms=bound_s(live_ops, live_bytes + cap * 2 * chunks(cap) * 8, "bf16")[0]
                * 1e3)), also=((lsets, k5_check),)),
    ]


def acquire_rows(dev) -> list[Row]:
    """P1's four launchers on the benchmark's own inputs (2048 keypoints,
    seed 0), each at rtol 1e-5 of its plain version (the sum order
    differs). Bound: the union of the windows read once, the origins (and
    the rolls) in, the blocks out; an add a window element. Beside it the
    rate the windows stream at (2048 x 12,288 B over graph_ms; the 9.9 MB
    image stays in L2) and, staged, the share of window pieces that arrived
    by TMA (the kernel's own count over ``acquire.window_boxes``'s pieces)."""
    a_img, a_oy, a_ox, a_rxy = acquire.bench_inputs(2048, H, W, SEED)
    a_args = tuple(torch.as_tensor(a, device=dev) for a in (a_img, a_oy, a_ox, a_rxy))
    nkp = a_oy.shape[0]
    out_bytes = nkp // acquire.GROUP * 8 * 128 * 4
    window_bytes = nkp * acquire.P * acquire.PW * 4

    def check(out, ref):
        require(torch.allclose(out, ref, rtol=1e-5, atol=0.0), "P1 differs from plain")
        return float((out - ref).abs().max())

    def row(staged, roll):
        def extras(rec):
            more = dict(window_tb_s=window_bytes / (rec["graph_ms"] * 1e-3) / 1e12)
            if staged:
                tma = torch.zeros(1, dtype=torch.int32, device=dev)
                acquire.acquire(*a_args, staged, roll, tma)
                boxes = acquire.window_boxes(*a_args[1:], roll, *a_img.shape,
                                             base_aligned=a_args[0].data_ptr() % 16 == 0)
                more["tma_share"] = int(tma) / sum(len(kp) for kp in boxes)
            return more

        rows, cols = acquire.window_index(*a_args[1:], roll, *a_img.shape)
        covered = torch.zeros(a_img.shape, dtype=torch.bool, device=dev)
        covered[rows, cols] = True
        nbytes = 4 * int(covered.sum()) + 8 * nkp + (8 * nkp if roll else 0) + out_bytes
        return Row(acquire.KERNELS[(staged, roll)].name, acquire.KERNELS[(staged, roll)],
                   lambda *a: acquire.acquire(*a, staged, roll), a_args,
                   lambda *a: acquire.acquire_plain(*a, roll), check,
                   bound_s(nkp * acquire.P * acquire.PW, nbytes), extras=extras)

    return [row(staged, roll) for _, staged, roll in acquire.VARIANTS]


def replayed_kernels(fn, *args) -> list:
    """The kernels one call of ``fn`` replayed from a CUDA graph puts on the
    device, each with its device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def probe_rows(dev) -> list[Row]:
    """P2: each probe by what the TPU probe asserts and against its plain
    version (exact, the two products at 1e-3). Bound: inputs and output
    once, the products' multiply-adds at the rate of their type."""
    library = {probes.SCALE_BY_SCALAR: lambda s_, x: torch.mul(x, s_[2]),
               probes.TRANSPOSE: lambda x: x.t().contiguous(),
               probes.BLOCK_DIAG: torch.block_diag, probes.SMALL_DOT: torch.mm}

    def row(p):
        args = p.inputs(dev)
        out = p.fn(*args)
        nbytes = sum(a.numel() * a.element_size() for a in args) + out.numel() * 4
        if p.kernel is probes.LANE_LANE_DOT:
            bound = bound_s(2.0 * 16 * args[1].shape[0] * args[0].shape[1], nbytes, "bf16")
        elif p.kernel is probes.SMALL_DOT:
            bound = bound_s(2.0 * out.numel() * args[0].shape[1], nbytes)
        else:
            bound = bound_s(out.numel() if p.kernel is probes.SCALE_BY_SCALAR else 0, nbytes)
        tol = 1e-3 if p.kernel in (probes.LANE_LANE_DOT, probes.SMALL_DOT) else 0.0

        def check(out, ref):
            ok, err = p.judge(out.cpu().numpy(), args)
            perr = float((out - ref).abs().max())
            require(ok and perr <= tol, f"P2 {p.name}: check {ok} (error {err}), "
                                        f"against plain {perr} > {tol}")
            return perr

        lib = library.get(p.kernel)
        return Row(p.kernel.name, p.kernel, p.fn, args, p.plain, check, bound, library=lib,
                   library_args=args,
                   extras=None if lib is None else
                   lambda rec: dict(library_graph_kernels=replayed_kernels(lib, *args)))

    return [row(p) for p in probes.PROBES]


def homography_rows(inp) -> list[Row]:
    """RANSAC's scoring on the flow's 10000 hypotheses (and its rescore of
    one), the weighted refit on its first LO refit (one weighting), checked
    too on the other three and with three weightings (IRLS's shape)."""
    (s_args, rescore), lo = inp.scored, inp.refits[0]
    s_live, s_num = int(s_args[5]), s_args[0].shape[0]

    def score_check(out, ref):  # counts equal; MSAC at rtol 1e-5 (sum order) with one argmin
        require(torch.equal(out[0], ref[0]), "RANSAC scoring counts differ from plain")
        require(torch.allclose(out[1], ref[1], rtol=1e-5, atol=0.0),
                f"RANSAC scoring MSAC differs: max rel "
                f"{float(((out[1] - ref[1]) / ref[1]).abs().max())}")
        require(int(torch.argmin(out[1])) == int(torch.argmin(ref[1])),
                "RANSAC scoring argmin differs")
        return float((out[1] - ref[1]).abs().max())

    def refit_check(out, ref):  # ok equal; a at rtol 1e-4 (the same QR, each sum's order)
        require(torch.equal(out[1], ref[1]) and bool(out[1].any()),
                f"refit ok {out[1].tolist()} against plain {ref[1].tolist()}")
        require(torch.allclose(out[0], ref[0], rtol=1e-4, atol=1e-5),
                f"refit differs from plain by {(out[0] - ref[0]).abs().max()}")
        return float((out[0] - ref[0]).abs().max())

    three = lo[:2] + (lo[2].expand(3, -1).contiguous(),) + lo[3:]
    r_live = int(lo[5])
    # The QR's float32 work on a live point's 2 rows a weighting: 56
    # projections of 4 flop, 8 norms of 2, 8 normalisations and Q^T b of 3.
    qr_ops = 2 * r_live * (56 * 4 + 8 * 2 + 8 * 3)
    return [
        # Bound: about 30 flop a (hypothesis, live point) pair; the live
        # points' 16 bytes, 32 bytes in and 12 out a hypothesis.
        Row("ransac_score", ransac.SCORE_KERNEL, ransac.inlier_counts, s_args,
            ransac.inlier_counts_plain, score_check,
            bound_s(30.0 * s_num * s_live, 16 * s_live + (32 + 12) * s_num),
            plain_timing=(5, 1), extras=lambda rec: dict(
                rescore_graph_ms=time_ms_graph(ransac.inlier_counts, s_args[0][:1], *s_args[1:]),
                hypotheses=s_num, live=s_live, slots=s_args[1].shape[0]),
            also=((rescore, score_check),)),
        # Bound: each live point's 18 + B floats read once, and the QR's work.
        Row("lstsq8", lstsq.KERNEL, lstsq.weighted_lstsq8, lo, lstsq.weighted_lstsq8_plain,
            refit_check, bound_s(qr_ops, 4 * (18 + 1) * r_live), plain_graph=True,
            plain_timing=(5, 1), extras=lambda rec: dict(
                three_graph_ms=time_ms_graph(lstsq.weighted_lstsq8, *three),
                three_plain_graph_ms=time_ms_graph(lstsq.weighted_lstsq8_plain, *three),
                three_bound_ms=bound_s(3 * qr_ops, 4 * (18 + 3) * r_live)[0] * 1e3,
                live=r_live, slots=lo[0].shape[0]),
            also=tuple((r, refit_check) for r in inp.refits[1:] + [three])),
    ]


def scale_up_row(dev) -> Row:
    """ScaleUp on the upscale cell's 1280x960 frame, equal to plain. Bound:
    the frame read once, its upsample written once: 20 bytes and 8 flop an
    input pixel. Replayed, the output stays in the 50 MB L2."""
    img = torch.as_tensor(synth.make_leaves_image(960, 1280, SEED), device=dev)

    def check(out, ref):
        require(torch.equal(out, ref),
                f"ScaleUp differs from plain: max abs {float((out - ref).abs().max())}")
        return 0.0

    px = 960 * 1280
    return Row("scale_up", scale_up.KERNEL, scale_up.scale_up, (img,), convolve.scale_up, check,
               bound_s(8 * px, 20 * px), loop=True, plain_graph=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    build_all()
    head, floors = floor_record(dev)
    inp = produce(dev)
    rows = (pyramid_rows(inp) + keypoint_rows(inp) + matcher_rows(inp)
            + acquire_rows(dev) + probe_rows(dev) + homography_rows(inp) + [scale_up_row(dev)])
    # Every launcher of the process has a row but the tracing's stamp.
    require({r.kernel for r in rows} | {probes.LAUNCH_FLOOR} == set(Kernel.instances)
            - {trace.STAMP} and len({r.name for r in rows}) == len(rows) == 24,
            f"rows {[r.name for r in rows]} for {[k.name for k in Kernel.instances]}")
    records = [head] + [run_row(r, floors, inp.flow) for r in rows]
    log("done")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
