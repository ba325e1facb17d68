#!/usr/bin/env python3
"""Drive the PyTorch port (``cudasift_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles every kernel source in ``cudasift_tpu_torch/csrc`` (one
   nvcc per source, all at once) and the C++ host codec (g++).
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the main path on a 1920x1080 frame (the matchers at
   4096 x 4096), with the stated tolerances (K1, K2 valid flags and K8
   equal), both timed with CUDA events: single calls (``ms``), every kernel
   also as 100 calls replayed from one CUDA graph (``graph_ms``, the device
   time without the host's dispatch), K1, K8 and the matchers also over 100
   calls back to back (``loop_ms``); beside them the least time the card
   could take (``bound_ms``) and, where one PyTorch call computes the same
   function, that call's time (``library_ms``; the port never calls it),
   also graph-replayed (``library_graph_ms``).
   K3 in its samplers, also on the octave-0 keypoints of the dead-leaves
   frame (the main path's shape) and run twice for equal bits; K6 with its
   peak search inside (the peaks equal to ``histogram_peaks`` of its own
   histograms); K2 equal to plain at the five octave shapes. First of all the
   card's launch floor: an empty kernel graph-replayed at one block and at
   K2's and K6's grids (``floor_ms`` on every row);
   the patch-acquisition kernels (P1) on the benchmark's own inputs; the
   eight capability probes (P2). K4 also with its second-best output
   (``match_top2``), against plain and against the call without it.
4. Main path, fused: the reference demo flow on two synthetic 1920x1080
   frames (frame B is frame A warped by a known homography) -- extract,
   match, RANSAC, refinement -- with the launch counters set to 0 just
   before it and read just after; the refined homography must map the frame
   corners within 1 px of the truth. ``extract_sift`` replays one captured
   CUDA graph per (shape, params): every flow's two ``SiftData`` must equal
   the eager run's (``utils.jit.disable_graphs``) field by field and count
   the same launches, and extraction is timed both ways, by CUDA events and
   by the host's clock. ``match_sift_data``, ``find_homography`` and
   ``improve_homography`` replay their programs too (captured first, each
   program's memory measured around its capture): in every flow their
   outputs, replayed and as the flow got them, must equal the eager run's
   bit for bit with the same generator seed and launches; on the blocks and
   the leaves flow each is timed both ways (events, host clock) with its
   kernels and the device's busy share (``torch.profiler``).
4b. Main path, split: the flow with ``use_fused=False,
   use_pallas_compact=True`` (compaction, orientation-histogram and
   descriptor kernels in place of the fused one) on the blocks pair, its
   corner error recorded but not gated (too few matches pass its ratio
   test); then on a dead-leaves pair (``synth.make_leaves_image``, whose
   ratio test has margin) the fused flow, the fused flow with the ``fast``
   sampler and the split flow, each with the same gates; then the matcher
   (K4) against its plain version and both matchers timed on the fused
   leaves flow's 32768-slot sets, the hybrid matcher on the split flow's
   descriptor sets against the exact one, the compaction kernel on and off
   (bit-identical), and split against fused. Then RANSAC's scoring kernel
   (``ops.cuda.ransac``) on the hypotheses the fused leaves flow's RANSAC
   scores, cut to the benchmark's 10000: counts equal to plain, MSAC sums
   at rtol 1e-5 with the same argmin, timed single, graph-replayed (and at
   the rescore's one hypothesis) and against plain, beside its bound and
   the launch floor at its grid. Then the weighted refit
   (``ops.cuda.lstsq``) on the four LO refits of the fused leaves flow's
   RANSAC and at three weightings (IRLS's shape): ok equal to the plain QR and a at
   rtol 1e-4, timed single, graph-replayed and against plain, beside its
   bound and the launch floor at its grid.
   Then ScaleUp (``ops.cuda.scale_up``) on a
   1280x960 dead-leaves frame: equal to plain bit for bit, timed single,
   over 100 calls and graph-replayed against plain and its bound; and the
   upscale cell's extraction (``scale_up=True``, thresh 3.0) at that frame,
   one ScaleUp launch a call, replayed equal to eager.
   Then the device time of one fused leaves flow without the host's
   dispatch: K1, K2 and K3 graph-replayed at the shapes of each of frame
   A's five octaves, K4 on the flow's own sets, summed over two extractions
   and one match, beside the launches of that flow. Then the fused leaves
   frame layer by layer, each graph-replayed (pyramid, K1, compaction, K2,
   K3, merge; the rest of the whole frame's replay is glue), the kernels a
   frame launches (``torch.profiler``), and ``extract_sift_throughput`` on
   four 1920x1080 frames in one program against four single calls.
4d. ``cudasift_tpu_torch.parallel``: those four frames through
   ``extract_sift_throughput_sharded`` and ``extract_sift_batched`` on a
   mesh that names the card four times, and on every card there is, each
   equal to the four single calls; the sharded matcher on the fused leaves
   flow's sets and on 4096 x 16384 unit sets, equal to single-device K4;
   then ``parallel.dryrun.dryrun_multichip(4)``.
4c. The demo CLI (``cudasift_tpu_torch.cli``) on the card, in-process, on
   the dead-leaves pair written as PGM files; then the patch-acquisition
   benchmark and the probe runner, each with the counters at 0.

Every wrapper launches on the current stream and never waits for the host
when its counts are tensors on the card, so every row is captured.
Prints its wall time, one JSON line with the kernels' numbers, then as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero without that line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

T_START = time.perf_counter()
H, W = 1080, 1920
SEED = 0
# The CLI's numFit floor on the dead-leaves pair (frames rounded to PGM,
# thresh 3.0): its first run on an H100 gave 7233; 10% below that.
CLI_MIN_FIT = 6500

# Published peaks of one NVIDIA H100 SXM at its full 700 W limit: device
# memory bytes/s, and dense operations/s by type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound(nbytes: float, ops: float, kind: str = "f32") -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of ``nbytes``
    over the memory rate and ``ops`` over the peak rate of ``kind``, and
    which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def keypoint_square(scale, reach: float, per_scale: float):
    """Bytes of the image squares that live keypoints read: side
    2 * ceil(per_scale * scale + reach) + 1 pixels each."""
    import torch

    side = 2 * torch.ceil(per_scale * scale + reach) + 1
    return float((side * side).sum()) * 4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def stamp(phase: str) -> None:
    """Log the wall time since the start as a phase begins."""
    log(f"[{time.perf_counter() - T_START:.1f} s] {phase}")


def bf16_flip_case(np):
    """The JAX package's adversarial near-tie (tests/test_pallas.py): a
    query and 64 rows where the bfloat16x3 sweep ranks row 20 above row 40
    while the exact float32 scores rank 40 first."""
    q = np.full(128, 1.001, np.float32)

    def exact64(x):
        return float(q.astype(np.float64) @ x.astype(np.float64))

    cand_a = np.full(128, 1.0048125, np.float32)
    cand_a[:30] = np.float32(0.997)
    cand_b = np.full(128, 1.003, np.float32)
    diff = exact64(cand_a) - exact64(cand_b)
    cand_b[:100] += np.float32((diff + 1e-4) / 1.001 / 100)
    d2 = np.random.default_rng(7).standard_normal((64, 128)).astype(np.float32) * 0.01
    d2[20] = cand_a
    d2[40] = cand_b
    return np.stack([q] * 8), d2


def near_ties(a, b, got, ref):
    """Rows where two matchers picked different columns of ``b`` for rows
    of ``a`` (float64): their count and the largest difference between the
    float64 scores of the two picks (0 when none differ)."""
    rows = (got != ref).nonzero()[:, 0]
    if len(rows) == 0:
        return 0, 0.0
    q = a[rows]
    s_got = (q * b[got[rows].long()]).sum(dim=1)
    s_ref = (q * b[ref[rows].long()]).sum(dim=1)
    return len(rows), float((s_got - s_ref).abs().max())


def main() -> int:
    import torch

    # ---- 1. Device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)

    import numpy as np

    import cudasift_tpu_torch as ct
    from cudasift_tpu_torch import cli, parallel
    from cudasift_tpu_torch.ops import convolve, detect
    from cudasift_tpu_torch.ops import match as match_plain
    from cudasift_tpu_torch.ops import orient as orient_plain
    from cudasift_tpu_torch.ops.cuda import (FUSED_PATH, HOMOGRAPHY, KERNELS, LIBRARY,
                                             SPLIT_PATH, UPSCALE, acquire, compact, descriptor,
                                             dog, lstsq, match, orient, orient_desc, probes,
                                             ransac, refine, scale_up)
    from cudasift_tpu_torch.parallel.dryrun import dryrun_multichip
    from cudasift_tpu_torch.pipeline import _compact, _extract_octave
    from cudasift_tpu_torch.utils import jit, native, synth
    from cudasift_tpu_torch.utils.build import build
    from cudasift_tpu_torch.utils.io import read_pgm, write_pgm
    from cudasift_tpu_torch.utils.timers import time_fn, time_ms, time_ms_graph, time_ms_loop

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. Build --------------------------------------------------------
    stamp("build")
    t0 = time.perf_counter()
    sources = sorted({(k.source, k.flags) for k in KERNELS + HOMOGRAPHY + UPSCALE})
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        codec = pool.submit(native.have_native)
        libs = list(pool.map(lambda sf: build(*sf), sources))
        require(codec.result(), "the C++ host codec did not build (no g++)")
    for k in KERNELS + HOMOGRAPHY + UPSCALE:
        k.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {[p.name for p in libs]} + host codec")

    # ---- 3. Each kernel against its plain version ------------------------
    stamp("kernels")
    # The launch floor first: an empty kernel, graph-replayed 100 times, at
    # one block and at the grids of the two launch-bound kernels of the flows
    # (K2: a warp a block; K6: four slots a block of 128 threads; 5120 slots
    # at octave 0 of a 1920x1080 frame). No kernel of that grid can take less;
    # a kernel's time is read against the larger of this and its bound.
    floor_grids = {"one_block": (1, 32), "refine": (5120 // 32, 32), "orient": (5120 // 4, 128),
                   # RANSAC's scoring: 10000 hypotheses, 512 a block, x 32768 / 256 splits.
                   "ransac_score": (-(-10000 // 512) * (32768 // 256), 128),
                   # The refit: a cluster of 8 blocks of 1024, one weighting.
                   "lstsq8": (8, 1024)}
    floors = {name: time_ms_graph(probes.launch_floor, dev, *grid)
              for name, grid in floor_grids.items()}
    results = {"probe_launch_floor": dict(
        max_abs_err=0.0, ms=time_ms(probes.launch_floor, dev),
        graph_ms=floors["one_block"], plain_ms=time_ms(probes.launch_floor_plain, dev),
        bound=bound(0, 0), library_ms=None,
        floor_by_grid={name: dict(blocks=g[0], threads=g[1], graph_ms=floors[name])
                       for name, g in floor_grids.items()})}
    log(f"launch floor (empty kernel, graph-replayed): {json.dumps(floors)} ms")

    params = ct.SiftParams(num_octaves=5, init_blur=1.0, thresh=3.0, max_pts=32768)
    frame_a = synth.make_test_image(H, W, SEED)
    h_true = synth.known_homography(H, W)
    frame_b = synth.warp_image(frame_a, h_true)
    img_a = torch.as_tensor(frame_a, device=dev)
    img_b = torch.as_tensor(frame_b, device=dev)
    # The split path's pair: a dead-leaves frame, whose ratio test has margin
    # (the blocks pair above passes only about 8 matches through the 0.8
    # gate), and its warp by the same homography.
    leaves_a = synth.make_leaves_image(H, W, SEED)
    leaf_a = torch.as_tensor(leaves_a, device=dev)
    leaf_b = torch.as_tensor(synth.warp_image(leaves_a, h_true), device=dev)

    def octave_bases(img):
        out = [convolve.low_pass(img, params.init_blur)]
        for _ in range(params.num_octaves - 1):
            out.append(convolve.scale_down(out[-1]))
        return [b.contiguous() for b in out]

    bases = octave_bases(img_a)
    leaf_bases = octave_bases(leaf_a)
    taps = params.laplace_kernels

    # K1 on the octave-0 base and on octave 2. Tolerance: none, both outputs
    # equal (the kernel keeps the plain version's order of operations).
    for o in (0, 2):
        base = bases[o].contiguous()
        got_dog, got_mask = dog.dog_and_mask(base, taps[o], params.thresh, params.edge_limit)
        ref_dog, ref_mask = dog.dog_and_mask_plain(base, taps[o], params.thresh,
                                                   params.edge_limit)
        torch.cuda.synchronize()
        err = float((got_dog - ref_dog).abs().max())
        sym = int((got_mask != ref_mask).sum())
        require(torch.equal(got_dog, ref_dog) and torch.equal(got_mask, ref_mask),
                f"K1 differs at octave {o}: dog max abs {err}, {sym} mask entries")
        log(f"K1 octave {o} {tuple(base.shape)}: dog and mask equal to plain, "
            f"mask {int(ref_mask.sum())} set")
    base0 = bases[0].contiguous()
    k1_args = (base0, taps[0], params.thresh, params.edge_limit)
    # Bound: the base and taps in, 7 DoG planes (f32) and 5 mask planes
    # (bool) out; per pixel 8 blurs of two 9-tap passes (17 operations
    # each), 7 differences, and 5 scales of 26 comparisons plus an edge test
    # of about 10 operations.
    hw = H * W
    results["dog"] = dict(
        max_abs_err=0.0, ms=time_ms(dog.dog_and_mask, *k1_args),
        loop_ms=time_ms_loop(dog.dog_and_mask, *k1_args, n=100),
        graph_ms=time_ms_graph(dog.dog_and_mask, *k1_args),
        leaves_graph_ms=time_ms_graph(dog.dog_and_mask, leaf_bases[0], *k1_args[1:]),
        plain_ms=time_ms(dog.dog_and_mask_plain, *k1_args),
        bound=bound(4 * hw + 4 * taps[0].size + 7 * 4 * hw + 5 * hw,
                    hw * (8 * 2 * 17 + 7 + 5 * (26 + 10))),
        library_ms=None)
    log(f"K1 at octave 0 {tuple(base0.shape)}: single {results['dog']['ms']:.4f} ms, over 100 "
        f"{results['dog']['loop_ms']:.4f} ms, graph-replayed {results['dog']['graph_ms']:.4f} ms "
        f"(leaves A {results['dog']['leaves_graph_ms']:.4f} ms), bound "
        f"{results['dog']['bound'][0]:.4f} ms")

    # K2 on octave 0's real candidates. Tolerance: valid equal, fields at
    # rtol 3e-7 (1 ulp of exp2 between the kernel and PyTorch).
    dog0, mask0 = dog.dog_and_mask(base0, taps[0], params.thresh, params.edge_limit)
    cap0 = params.candidate_capacity(H, W, 0)
    flat_idx, count, total = detect.compact_mask(mask0, cap0, with_total=True)
    low0 = params.lowest_scale_effective
    got = refine.refine_candidates(dog0, flat_idx, count, params.edge_limit, low0)
    ref = detect.refine_candidates(dog0, flat_idx, count, params.edge_limit, low0)
    require(torch.equal(got.valid, ref.valid), "K2 valid differs")
    k2_err = 0.0
    for name in ("xpos", "ypos", "scale", "sharpness", "edgeness"):
        a, b = getattr(got, name), getattr(ref, name)
        require(torch.allclose(a, b, rtol=3e-7, atol=0.0), f"K2 {name} differs")
        k2_err = max(k2_err, float((a - b).abs().max()))
    log(f"K2: {int(count)} candidates of {int(total)} in {cap0} slots, "
        f"{int(got.valid.sum())} valid, max abs err {k2_err:.3g}")
    # Bound: the indices and count in, a 3x3x3 DoG cube per candidate, five
    # f32 fields and the validity out for every slot; about 200 operations
    # per candidate (gradient, Hessian, 3x3 solve, tests).
    ncand = int(count)
    results["refine"] = dict(
        max_abs_err=k2_err,
        ms=time_ms(refine.refine_candidates, dog0, flat_idx, count,
                   params.edge_limit, low0),
        graph_ms=time_ms_graph(refine.refine_candidates, dog0, flat_idx, count,
                               params.edge_limit, low0),
        plain_ms=time_ms(detect.refine_candidates, dog0, flat_idx, count,
                         params.edge_limit, low0),
        bound=bound(4 * cap0 + 4 + 27 * 4 * ncand + 5 * 4 * cap0 + cap0, 200 * ncand),
        library_ms=None)

    # K3 on those refined keypoints, in the default sampler (shift) and the
    # fast one. Tolerance: orientation median error < 0.2 deg and >= 90%
    # within 2 deg, has2 agreement >= 90%; on the keypoints whose
    # orientations agree (>= 90% of them), descriptor per-row max-abs error
    # median < 4e-3 and max < 2e-2.
    sc = torch.where(got.valid, got.scale, 1.0)
    live = got.valid
    nlive = int(live.sum())
    require(nlive > 0, "K3 has no live keypoints")

    def k3_bound(xpos, scale, valid, has2):
        """K3's bound. Positions, scales and the live mask in, each live
        keypoint's image square (reach 7.96 * scale + 2.5 px) read once,
        both descriptor tables and the orientations out for every slot;
        about 6000 operations for a keypoint's orientation and 256 grid
        samples of about 60 (sampler, magnitude, angle, binning) per
        descriptor."""
        n = xpos.shape[0]
        nl = int(valid.sum())
        ndesc = nl + int((has2 & valid).sum())
        nbytes = (13 * n + keypoint_square(scale[valid], 2.5, 7.96)
                  + 2 * 128 * 4 * n + 9 * n)
        return bound(nbytes, 6000 * nl + 256 * 60 * ndesc)

    def check_k3(mode):
        k3_args = (base0, got.xpos, got.ypos, sc, got.valid, mode)
        kd1, kd2, ko1, ko2, kh2 = orient_desc.orient_and_describe(*k3_args)
        pd1, pd2, po1, po2, ph2 = orient_desc.orient_and_describe_plain(*k3_args)
        dori = (ko1 - po1).abs()[live]
        dori = torch.minimum(dori, 360.0 - dori)
        require(float(dori.median()) < 0.2 and float((dori < 2.0).float().mean()) >= 0.9,
                f"K3 {mode} orientations differ: median {float(dori.median())}")
        agree2 = float((kh2 == ph2)[live].float().mean())
        require(agree2 >= 0.9, f"K3 {mode} has2 agrees on {agree2}")
        same = live & ((ko1 - po1).abs() < 1e-3)
        require(int(same.sum()) >= 0.9 * nlive, f"K3 {mode} orientations agree on < 90%")
        rowerr = (kd1 - pd1).abs().max(dim=1).values[same]
        require(float(rowerr.median()) < 4e-3 and float(rowerr.max()) < 2e-2,
                f"K3 {mode} descriptors differ: median {float(rowerr.median())}, "
                f"max {float(rowerr.max())}")
        norms = kd1[live].norm(dim=1)
        require(bool(((norms - 1.0).abs() < 1e-4).all()),
                f"K3 {mode} descriptors are not unit length")
        again = orient_desc.orient_and_describe(*k3_args)
        require(all(torch.equal(a, b) for a, b in zip((kd1, kd2, ko1, ko2, kh2), again)),
                f"K3 {mode} is not deterministic")
        log(f"K3 {mode}: {nlive} live, orientation median err {float(dori.median()):.3g} deg, "
            f"has2 agreement {agree2:.4f}, descriptor row err median "
            f"{float(rowerr.median()):.3g} max {float(rowerr.max()):.3g}, two runs equal")
        return dict(max_abs_err=float(rowerr.max()),
                    ms=time_ms(orient_desc.orient_and_describe, *k3_args),
                    graph_ms=time_ms_graph(orient_desc.orient_and_describe, *k3_args),
                    plain_ms=time_ms(orient_desc.orient_and_describe_plain, *k3_args, iters=5),
                    bound=k3_bound(got.xpos, sc, got.valid, kh2),
                    library_ms=None)

    results["orient_desc"] = check_k3("shift")
    results["orient_desc_fast"] = check_k3("fast")

    # K4 at 4096 x 4096 with an n2 mask. Tolerance: indices equal on every
    # row, scores at rtol 1e-5 / atol 1e-6 (3xTF32 keeps float32 fidelity;
    # the closest best-second gap of these rows is 7.3e-7 in float64).
    rng = np.random.default_rng(SEED)
    d1 = rng.standard_normal((4096, 128)).astype(np.float32)
    d2 = rng.standard_normal((4096, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    d1 = torch.as_tensor(d1, device=dev)
    d2 = torch.as_tensor(d2, device=dev)
    n1 = torch.tensor(4096, dtype=torch.int32, device=dev)
    n2 = torch.tensor(4001, dtype=torch.int32, device=dev)
    ks, ka, ki = match.match_descriptors(d1, d2, 4096, n2)
    ps, pa, pi = match_plain.match_descriptors(d1, d2, 4096, n2)
    require(torch.equal(ki, pi), f"K4 indices differ on {int((ki != pi).sum())} rows")
    require(int(ki.max()) < 4001, "K4 matched a masked column")
    require(torch.allclose(ks, ps, rtol=1e-5, atol=1e-6), "K4 scores differ")
    k4_err = float((ks - ps).abs().max())
    log(f"K4: 4096 x 4096 (n2 4001), indices equal, score max abs err {k4_err:.3g}")
    # K4 with its second-best output (``match_top2``, the triple the sharded
    # matcher merges). Tolerance: second against the plain triple at rtol
    # 1e-5 / atol 1e-6; none between the two calls: the call without it (a
    # null pointer) gives the score and index of the call with it bit for
    # bit, and its ambiguity is second / (score + 1e-6) to the bit.
    tb, tsec, ti = match.match_top2(d1, d2, 4096, n2)
    psec = match_plain.match_top2(d1, d2, 4096, n2)[1]
    require(torch.equal(tb, ks) and torch.equal(ti, ki) and torch.equal(ka, tsec / (tb + 1e-6)),
            "K4 with its second output differs from the call without it")
    require(torch.allclose(tsec, psec, rtol=1e-5, atol=1e-6),
            f"K4 second differs from plain: max abs {float((tsec - psec).abs().max())}")
    log(f"K4 with its second output: score and index equal to the call without it, ambiguity "
        f"its second / (score + 1e-6) bit for bit, second max abs err against plain "
        f"{float((tsec - psec).abs().max()):.3g}")
    # Bound: both sets in, three (N1,) outputs; three TF32 products of
    # 4096 x 4001 x 128 multiply-adds on the tensor cores (bound_f32_ms:
    # one float32 product on the CUDA cores, the bound of the kernel before
    # the tensor cores). Library: torch.mm and torch.topk(k=2), two calls (no
    # single call computes a top-2 match). Times: the median single call
    # (ms), 100 calls back to back (loop_ms), with the counts on the card
    # so that no call waits for the host, and 100 calls replayed from one
    # CUDA graph (graph_ms; library_graph_ms for the library's two calls).
    top2 = lambda a, b, n: torch.topk(torch.mm(a, b[:n].t()), 2, dim=1)  # noqa: E731
    match_bytes = 2 * 4096 * 128 * 4 + 3 * 4096 * 4
    match_ops = 2.0 * 4096 * 4001 * 128
    results["match"] = dict(
        max_abs_err=k4_err,
        ms=time_ms(match.match_descriptors, d1, d2, 4096, n2),
        loop_ms=time_ms_loop(match.match_descriptors, d1, d2, n1, n2, n=100),
        graph_ms=time_ms_graph(match.match_descriptors, d1, d2, n1, n2),
        plain_ms=time_ms(match_plain.match_descriptors, d1, d2, 4096, n2),
        bound=bound(match_bytes, 3 * match_ops, "tf32"),
        bound_f32_ms=bound(match_bytes, match_ops)[0],
        library_ms=time_ms(top2, d1, d2, 4001),
        library_loop_ms=time_ms_loop(top2, d1, d2, 4001, n=100),
        library_graph_ms=time_ms_graph(top2, d1, d2, 4001),
        second_max_abs_err=float((tsec - psec).abs().max()))
    # The bfloat16 tier (use_bf16) against its plain version: scores at
    # rtol 1e-5 / atol 1e-6; indices equal but at near-ties of the rounded
    # inputs (float64 scores of the two picks within 1e-6).
    bs_, _, bi_ = match.match_descriptors(d1, d2, 4096, n2, use_bf16=True)
    ps_, _, pi_ = match_plain.match_descriptors(d1, d2, 4096, n2, use_bf16=True)
    require(torch.allclose(bs_, ps_, rtol=1e-5, atol=1e-6), "K4 bf16 tier scores differ")
    rd1, rd2 = (t.to(torch.bfloat16).double() for t in (d1, d2))
    nflip, flip_gap = near_ties(rd1, rd2, bi_, pi_)
    require(flip_gap <= 1e-6, f"K4 bf16 tier picks differ beyond a near-tie: {flip_gap}")
    log(f"K4 use_bf16: 4096 x 4096 (n2 4001), {nflip} indices differ at near-ties "
        f"(gap <= {flip_gap:.3g}), score max abs err {float((bs_ - ps_).abs().max()):.3g}, "
        f"{time_ms_loop(match.match_descriptors, d1, d2, n1, n2, True, n=100):.4f} ms per "
        f"call over 100")

    # K8 on the octave-0 and octave-2 masks of frame A and of the split
    # path's frame A (dead leaves, more candidates), with their capacities,
    # and one saturating mask (thresh 0.5) into 1024 slots. Tolerance:
    # indices, count and total equal. K6 and K7 then run on the dead-leaves
    # frame's candidates.
    cap2 = params.candidate_capacity(*bases[2].shape, 2)
    _, mask2 = dog.dog_and_mask(bases[2], taps[2], params.thresh, params.edge_limit)
    masks, dogs = {}, {}
    for o in (0, 2):
        dogs[o], masks[o] = dog.dog_and_mask(leaf_bases[o], taps[o], params.thresh,
                                             params.edge_limit)
    _, sat = dog.dog_and_mask(leaf_bases[0], taps[0], 0.5, params.edge_limit)
    k8_cases = [("frame A", mask0, cap0), ("frame A", mask2, cap2),
                ("leaves A", masks[0], cap0), ("leaves A", masks[2], cap2),
                ("leaves A, thresh 0.5", sat, 1024)]
    for what, mask, cap in k8_cases:
        got8 = compact.compact_mask(mask, cap)
        ref8 = detect.compact_mask(mask, cap, with_total=True)
        require(all(torch.equal(a, b) for a, b in zip(got8, ref8)),
                f"K8 differs on the {what} {tuple(mask.shape)} mask into {cap} slots")
        log(f"K8 {what} {tuple(mask.shape)} into {cap} slots: count {int(got8[1])} of "
            f"{int(got8[2])}, indices equal")
    require(int(got8[1]) == 1024 < int(got8[2]), "K8 saturating case did not saturate")
    # Bound: the mask (bool) in, indices, count and total out; one
    # operation per mask entry. Library: torch.nonzero_static of the flat
    # mask into the capacity, zero-filled (the same function but count and
    # total); beside it torch.nonzero (every set entry, uncapped; it waits
    # for the host to size its output).
    flat0 = masks[0].reshape(-1)
    k8_args = (masks[0], cap0)
    nonzero_static = lambda f: torch.nonzero_static(f, size=cap0, fill_value=0)  # noqa: E731
    results["compact"] = dict(
        max_abs_err=0.0, ms=time_ms(compact.compact_mask, *k8_args),
        loop_ms=time_ms_loop(compact.compact_mask, *k8_args, n=100),
        graph_ms=time_ms_graph(compact.compact_mask, *k8_args),
        plain_ms=time_ms(detect.compact_mask, masks[0], cap0, True),
        bound=bound(masks[0].numel() + 4 * cap0 + 8, masks[0].numel()),
        library_ms=time_ms(nonzero_static, flat0),
        library_loop_ms=time_ms_loop(nonzero_static, flat0, n=100),
        library_graph_ms=time_ms_graph(nonzero_static, flat0),
        nonzero_ms=time_ms(torch.nonzero, flat0))
    log(f"K8 on leaves A octave 0 ({flat0.numel()} entries into {cap0} slots): single "
        f"{results['compact']['ms']:.4f} ms, over 100 {results['compact']['loop_ms']:.4f} ms, "
        f"graph-replayed {results['compact']['graph_ms']:.4f} ms; torch.nonzero_static "
        f"{results['compact']['library_ms']:.4f} ms (graph-replayed "
        f"{results['compact']['library_graph_ms']:.4f} ms), torch.nonzero "
        f"{results['compact']['nonzero_ms']:.4f} ms")

    # K6 on the octave-0 candidates, refined and front-packed as the split
    # path packs them. Tolerance: histograms at rtol 1e-5 (atol 1e-6 for
    # empty bins; only the order of each bin's sum differs), primary peaks
    # within 1e-3 deg on >= 99% of the live slots.
    lbase0 = leaf_bases[0]
    lidx, lcount = compact.compact_mask(masks[0], cap0)[:2]
    lc = refine.refine_candidates(dogs[0], lidx, lcount, params.edge_limit, low0)
    f0, live0, _ = _compact({"xpos": lc.xpos, "ypos": lc.ypos, "scale": lc.scale},
                            lc.valid, cap0)
    nl0 = int(live0)
    pk = torch.arange(cap0, device=dev) < live0
    sc0 = torch.where(pk, f0["scale"], 1.0)
    k6_args = (lbase0, f0["xpos"], f0["ypos"], sc0, live0)
    kh, kp1, kp2, kh2 = orient.orientation_peaks(*k6_args)
    ph, pp1, _, _ = orient.orientation_peaks_plain(*k6_args)
    require(nl0 > 0 and torch.allclose(kh, ph, rtol=1e-5, atol=1e-6),
            f"K6 histograms differ: max abs {float((kh - ph).abs().max())}")
    require(not kh[nl0:].any() and not kp1[nl0:].any() and not kp2[nl0:].any()
            and not kh2[nl0:].any(), "K6 wrote past the count")
    # The peaks inside the kernel: those of histogram_peaks on the kernel's
    # own histograms, equal; against the plain version's (whose histograms
    # differ in the last bits) within 1e-3 deg on >= 99% of the live slots.
    own = orient_plain.histogram_peaks(kh)
    require(all(torch.equal(a[:nl0], b[:nl0]) for a, b in zip((kp1, kp2, kh2), own)),
            f"K6 peaks differ from histogram_peaks of its histograms: primary max abs "
            f"{float((kp1 - own[0])[:nl0].abs().max())}, secondary "
            f"{float((kp2 - own[1])[:nl0].abs().max())}, has_second on "
            f"{int((kh2 != own[2])[:nl0].sum())}")
    again6 = orient.orientation_peaks(*k6_args)
    require(all(torch.equal(a, b) for a, b in zip((kh, kp1, kp2, kh2), again6))
            and torch.equal(kh, orient.orientation_histograms(*k6_args)),
            "K6 is not deterministic")
    dp = (kp1 - pp1).abs()[:nl0]
    dp = torch.minimum(dp, 360.0 - dp)
    share6 = float((dp < 1e-3).float().mean())
    require(share6 >= 0.99, f"K6 peaks agree on {share6}")
    k6_err = float((kh - ph).abs().max())
    log(f"K6: {nl0} live of {cap0} slots, histogram max abs err {k6_err:.3g}, peaks equal to "
        f"histogram_peaks of its histograms ({int(kh2.sum())} second peaks), primary peaks "
        f"within 1e-3 deg of plain on {share6:.4f}, two runs equal")
    # Bound: positions, scales and the count in, each live keypoint's
    # 17 x 17 image square, the (slots, 32) histograms and the peaks (two
    # floats and a flag) out; about 40 operations for each of 121 samples
    # per live keypoint. Times are of the call with the peaks;
    # hist_graph_ms is the histogram-only call.
    results["orient"] = dict(
        max_abs_err=k6_err, ms=time_ms(orient.orientation_peaks, *k6_args),
        graph_ms=time_ms_graph(orient.orientation_peaks, *k6_args),
        hist_graph_ms=time_ms_graph(orient.orientation_histograms, *k6_args),
        plain_ms=time_ms(orient.orientation_peaks_plain, *k6_args),
        bound=bound(12 * cap0 + 4 + nl0 * 17 * 17 * 4 + cap0 * (32 * 4 + 9), nl0 * 121 * 40),
        library_ms=None)
    log(f"K6 graph-replayed: with peaks {results['orient']['graph_ms']:.5f} ms, histograms "
        f"only {results['orient']['hist_graph_ms']:.5f} ms, floor at its grid "
        f"{floors['orient']:.5f} ms; K2 {results['refine']['graph_ms']:.5f} ms, floor at its "
        f"grid {floors['refine']:.5f} ms")

    # K7 on those keypoints at their K6 orientations. Tolerance: row max-abs
    # error <= 1e-5, unit norms within 1e-4, zeros past the count, two runs
    # bit-identical.
    ori0 = kp1
    k7_args = (lbase0, f0["xpos"], f0["ypos"], sc0, ori0, live0)
    kd = descriptor.extract_descriptors(*k7_args)
    pd = descriptor.extract_descriptors_plain(*k7_args)
    k7_err = float((kd - pd).abs().max())
    require(k7_err <= 1e-5, f"K7 descriptors differ: max abs {k7_err}")
    require(bool(((kd[:nl0].norm(dim=1) - 1.0).abs() < 1e-4).all()),
            "K7 descriptors are not unit length")
    require(not kd[nl0:].any(), "K7 wrote past the count")
    require(torch.equal(kd, descriptor.extract_descriptors(*k7_args)), "K7 is not deterministic")
    log(f"K7: {nl0} live of {cap0} slots, descriptor max abs err {k7_err:.3g}")
    # Bound: positions, scales, orientations and the count in, each live
    # keypoint's image square (reach 7.96 * scale + 2.5 px), the (slots,
    # 128) descriptors out; 256 samples of about 70 operations (four
    # bilinear taps, magnitude, angle, binning) per live keypoint.
    results["descriptor"] = dict(
        max_abs_err=k7_err, ms=time_ms(descriptor.extract_descriptors, *k7_args),
        graph_ms=time_ms_graph(descriptor.extract_descriptors, *k7_args),
        plain_ms=time_ms(descriptor.extract_descriptors_plain, *k7_args),
        bound=bound(16 * cap0 + 4 + keypoint_square(sc0[:nl0], 2.5, 7.96) + cap0 * 128 * 4,
                    nl0 * 256 * 70),
        library_ms=None)

    # K5 (the hybrid tier's sweep) at 4096 x 4096 with n2 = 4001, as K4.
    # Tolerance: against its plain version indices equal and scores at rtol
    # 1e-6; against K4 indices equal wherever K4's best-second gap exceeds
    # 1e-5 and scores within 1e-5. Then the JAX package's two adversarial
    # cases: a bfloat16 near-tie flip (index 40) and duplicates across
    # 2048-column tiles (index 50).
    def k5_agrees(a, b, what):
        hs, _, hi = a
        es, ea, ei = b
        second = ea * (es + 1e-6)
        decided = (es - second) > 1e-5
        require(torch.equal(hi[decided], ei[decided]),
                f"K5 {what}: indices differ on {int((hi != ei)[decided].sum())} decided rows")
        err = float((hs - es).abs().max())
        require(err <= 1e-5, f"K5 {what}: scores differ by {err}")
        return int(decided.sum()), int((hi == ei).sum()), err

    # The sweep's own candidates: columns equal but where two bfloat16x3
    # scores tie within the summation order's rounding (>= 99.9%), scores
    # within 1e-6 where the columns agree.
    ck = match.sweep_candidates(d1, d2, 4096, n2)
    cp = match_plain.sweep_candidates(d1, d2, 4096, n2)
    agree = ck[1] == cp[1]
    k5_err = float((ck[0] - cp[0]).abs()[agree].max())
    share5 = float(agree.float().mean())
    require(share5 >= 0.999 and k5_err <= 1e-6,
            f"K5 sweep differs: columns agree on {share5}, score err {k5_err}")
    hk = match.match_descriptors(d1, d2, 4096, n2, rescore_k=8)
    hp = match_plain.match_descriptors_hybrid(d1, d2, 4096, n2, 8)
    require(torch.equal(hk[2], hp[2]), f"K5 indices differ on {int((hk[2] != hp[2]).sum())}")
    require(torch.allclose(hk[0], hp[0], rtol=1e-6, atol=0.0), "K5 scores differ from plain")
    dec, same, err4 = k5_agrees(hk, (ks, ka, ki), "4096 x 4096")
    log(f"K5: 4096 x 4096 (n2 4001), candidates agree on {share5:.6f} (score max abs err "
        f"{k5_err:.3g}), matches equal to plain; against K4 {same} of 4096 indices equal, "
        f"{dec} rows decided, score err {err4:.3g}")
    fd1, fd2 = (torch.as_tensor(a, device=dev) for a in bf16_flip_case(np))
    require(match.sweep_candidates(fd1, fd2, 8, 64)[1][0, :2].tolist() == [20, 40],
            "K5 sweep is not fooled by the bf16-flip case: its split rounds otherwise")
    require(int(match.match_descriptors(fd1, fd2, 8, 64, rescore_k=8)[2][0]) == 40,
            "K5 bf16-flip case lost the exact winner")
    require(match.match_descriptors(fd1, fd2, 8, 64)[2].tolist() == [40] * 8,
            "K4's 3xTF32 tier lost the bf16-flip case's exact winner")
    rng5 = np.random.default_rng(3)
    nd = 2048 + 300
    dd2 = rng5.standard_normal((nd, 128)).astype(np.float32)
    dd2 /= np.linalg.norm(dd2, axis=1, keepdims=True)
    q = dd2[2048 + 100].copy()
    dd2[50] = q
    dd2[700] = q
    dup = match.match_descriptors(torch.as_tensor(np.stack([q] * 4), device=dev),
                                  torch.as_tensor(dd2, device=dev), 4, nd, rescore_k=8)
    require(dup[2].tolist() == [50] * 4, f"K5 duplicate tie-break gave {dup[2].tolist()}")
    log("K5: bf16-flip case -> index 40 (K4 too), duplicate tie-break -> index 50")
    # Bound: both sets in, the (N1, 32) candidate scores and columns out;
    # three bfloat16 products of 4096 x 4001 x 128 multiply-adds on the
    # tensor cores. Library: as K4's, torch.mm and torch.topk(k=2), the
    # float32 top-2 that the sweep and its rescore compute.
    nch = -(-4096 // match_plain.SWEEP_CHUNK)
    results["match_sweep"] = dict(
        max_abs_err=k5_err,
        ms=time_ms(match.sweep_candidates, d1, d2, 4096, n2),
        loop_ms=time_ms_loop(match.sweep_candidates, d1, d2, n1, n2, n=100),
        graph_ms=time_ms_graph(match.sweep_candidates, d1, d2, n1, n2),
        plain_ms=time_ms(match_plain.sweep_candidates, d1, d2, 4096, n2),
        bound=bound(2 * 4096 * 128 * 4 + 4096 * 2 * nch * 8, 3 * 2.0 * 4096 * 4001 * 128,
                    "bf16"),
        library_ms=time_ms(top2, d1, d2, 4001),
        library_loop_ms=results["match"]["library_loop_ms"],
        library_graph_ms=results["match"]["library_graph_ms"])
    log(f"K5 with its rescore (the whole rescore_k=8 tier): "
        f"{time_ms(match.match_descriptors, d1, d2, 4096, n2, False, 2048, 8):.4f} ms, "
        f"plain {time_ms(match_plain.match_descriptors_hybrid, d1, d2, 4096, n2, 8):.4f} ms")

    # P1 on the benchmark's own inputs (2048 keypoints, a 1136 x 2176
    # frame, seed 0): each variant against its plain version at rtol 1e-5
    # (the summation order differs). Bound: the union of the windows read
    # once (overlapping windows share bytes), the origins (and the used
    # realignments) in, the (256, 8, 128) blocks out; one add per window
    # element. Beside it the rate at which the windows themselves stream
    # (2048 x 12,288 B over graph_ms; the image, 9.9 MB, stays in the 50 MB
    # L2 across replays) and, for the staged kernel, the share of window
    # pieces that arrived by TMA: the kernel's own count of the boxes whose
    # barrier it waited on (acquire's tma_pieces) over the pieces
    # acquire.window_boxes cuts (one a keypoint here, so it must be 1.0). Its
    # single-call ms includes encoding the tensor map on the host.
    a_img, a_oy, a_ox, a_rxy = acquire.bench_inputs(2048, H, W, SEED)
    a_args = tuple(torch.as_tensor(a, device=dev) for a in (a_img, a_oy, a_ox, a_rxy))
    nkp = a_oy.shape[0]
    out_bytes = nkp // acquire.GROUP * 8 * 128 * 4
    window_bytes = nkp * acquire.P * acquire.PW * 4
    for name, staged, roll in acquire.VARIANTS:
        kern = acquire.KERNELS[(staged, roll)]
        tma = torch.zeros(1, dtype=torch.int32, device=dev) if staged else None
        got_p = acquire.acquire(*a_args, staged, roll, tma)
        ref_p = acquire.acquire_plain(*a_args, roll)
        require(torch.allclose(got_p, ref_p, rtol=1e-5, atol=0.0),
                f"P1 {name} differs: max rel err "
                f"{float(((got_p - ref_p).abs() / ref_p.abs().clamp(min=1.0)).max())}")
        rows, cols = acquire.window_index(a_args[1], a_args[2], a_args[3], roll, *a_img.shape)
        covered = torch.zeros(a_img.shape, dtype=torch.bool, device=dev)
        covered[rows, cols] = True
        nbytes = 4 * int(covered.sum()) + 8 * nkp + (8 * nkp if roll else 0) + out_bytes
        ms = time_ms(acquire.acquire, *a_args, staged, roll)
        graph_ms = time_ms_graph(acquire.acquire, *a_args, staged, roll)
        results[kern.name] = dict(
            max_abs_err=float((got_p - ref_p).abs().max()), ms=ms, graph_ms=graph_ms,
            plain_ms=time_ms(acquire.acquire_plain, *a_args, roll),
            bound=bound(nbytes, nkp * acquire.P * acquire.PW), library_ms=None,
            window_tb_s=window_bytes / (graph_ms * 1e-3) / 1e12)
        if staged:
            boxes = acquire.window_boxes(*a_args[1:], roll, *a_img.shape,
                                         base_aligned=a_args[0].data_ptr() % 16 == 0)
            pieces = sum(len(kp) for kp in boxes)
            require(pieces == nkp, f"P1 {name}: {pieces} window pieces, expected one a keypoint")
            share = int(tma) / pieces
            require(share == 1.0, f"P1 {name}: the kernel counted {int(tma)} of {pieces} "
                                  f"window pieces arriving by TMA")
            results[kern.name]["tma_share"] = share
        log(f"P1 {name}: {nkp} keypoints, equal to plain at rtol 1e-5, {ms:.4f} ms "
            f"({ms * 1e6 / nkp:.1f} ns per keypoint), graph-replayed {graph_ms:.5f} ms, windows "
            f"at {results[kern.name]['window_tb_s']:.3f} TB/s, bound "
            f"{results[kern.name]['bound'][0]:.4f} ms ({int(covered.sum())} distinct window "
            f"pixels)" + (f", TMA share {share}" if staged else ""))

    # P2: each probe against its plain version on the card, and against
    # what the TPU probe asserts (probes.PROBES). Bound: inputs and output
    # once; the products' multiply-adds at the rate of their type.
    def probe_bound(p, args, out):
        nbytes = sum(a.numel() * a.element_size() for a in args) + out.numel() * 4
        if p.kernel is probes.LANE_LANE_DOT:
            return bound(nbytes, 2.0 * 16 * args[1].shape[0] * args[0].shape[1], "bf16")
        if p.kernel is probes.SMALL_DOT:
            return bound(nbytes, 2.0 * out.numel() * args[0].shape[1])
        return bound(nbytes, out.numel() if p.kernel is probes.SCALE_BY_SCALAR else 0)

    # The kernels one call puts on the device when it is replayed from a
    # CUDA graph, each with its device time (torch.profiler): what a
    # library call's library_graph_ms is made of.
    def replayed_kernels(fn, *args):
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

    probe_library = {
        probes.SCALE_BY_SCALAR: lambda s_, x: torch.mul(x, s_[2]),
        probes.TRANSPOSE: lambda x: x.t().contiguous(),
        probes.BLOCK_DIAG: torch.block_diag,
        probes.SMALL_DOT: torch.mm,
    }
    for p in probes.PROBES:
        args = p.inputs(dev)
        out = p.fn(*args)
        ok, err = p.judge(out.cpu().numpy(), args)
        plain = p.plain(*args)
        perr = float((out - plain).abs().max())
        tol = 0.0 if p.kernel not in (probes.LANE_LANE_DOT, probes.SMALL_DOT) else 1e-3
        require(ok and perr <= tol, f"P2 {p.name}: check {ok} (error {err}), "
                                    f"against plain {perr} > {tol}")
        lib = probe_library.get(p.kernel)
        row = results[p.kernel.name] = dict(
            max_abs_err=perr, ms=time_ms(p.fn, *args), graph_ms=time_ms_graph(p.fn, *args),
            plain_ms=time_ms(p.plain, *args), bound=probe_bound(p, args, out),
            library_ms=None if lib is None else time_ms(lib, *args))
        if lib is not None:
            row["library_graph_ms"] = time_ms_graph(lib, *args)
            row["library_graph_kernels"] = replayed_kernels(lib, *args)
            log(f"P2 {p.name}: one library call replayed from a graph puts on the device "
                + "; ".join(f"{k} {us:.2f} us" for k, us in row["library_graph_kernels"]))
        log(f"P2 {p.name} ({p.kernel.name}): check passed (error {err:.3g}), "
            f"against plain {perr:.3g}, graph-replayed {row['graph_ms']:.5f} ms"
            + ("" if lib is None else f", library {row['library_graph_ms']:.5f} ms"))

    # The whole pipeline on a small input: CUDA kernels against the plain
    # versions on the CPU. Same point count, keypoint set overlap >= 0.97.
    small = synth.make_test_image(192, 256, SEED)
    sp = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=2048)
    on_gpu = ct.extract_sift(torch.as_tensor(small, device=dev), sp)
    on_cpu = ct.extract_sift(torch.as_tensor(small), sp)

    def keyset(d):
        n = int(d.num_pts)
        xyz = torch.stack([d.xpos[:n], d.ypos[:n], d.scale[:n]], 1).cpu().numpy()
        return {tuple(np.round(r, 2)) for r in xyz}

    kg, kc = keyset(on_gpu), keyset(on_cpu)
    overlap = len(kg & kc) / max(len(kg), len(kc), 1)
    require(len(kc) > 0 and overlap >= 0.97, f"small-input pipeline overlap {overlap}")
    log(f"small input 192x256: {int(on_gpu.num_pts)} points on the card, "
        f"{int(on_cpu.num_pts)} on the CPU, overlap {overlap:.4f}")

    # ---- 4. Main path ----------------------------------------------------
    stamp("main path")
    gen = torch.Generator(device=dev)
    hom_kw = dict(num_loops=10240, min_score=0.0, max_ambiguity=0.80, thresh=5.0)
    irls_args = (5, 0.0, 0.80, 3.0)

    def match_and_fit(da, db):
        gen.manual_seed(SEED)
        m = ct.match_sift_data(da, db)
        h1, nm = ct.find_homography(m, gen, **hom_kw)
        h2, nfit, err = ct.improve_homography(m, h1, *irls_args)
        return m, h1, nm, h2, nfit, err

    def demo_flow(fparams, fa, fb):
        da = ct.extract_sift(fa, fparams)
        db = ct.extract_sift(fb, fparams)
        return (da, db) + match_and_fit(da, db)

    # Kernels a call puts on the device and their summed device time, from
    # torch.profiler (memory copies and sets left out).
    def device_kernels(fn):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
        return dict(kernels=len(evs),
                    device_ms=sum(e.time_range.elapsed_us() for e in evs) / 1e3)

    # The memory each program holds: its private pool (the segments of
    # torch.cuda.memory_snapshot outside the default pool that its capturing
    # call adds) and its static copies of the inputs. Extraction at the main
    # path's shape, then RANSAC and IRLS on its two frames' matches
    # (matching runs eagerly).
    from cudasift_tpu_torch.ops import homography as homography_ops
    from cudasift_tpu_torch.pipeline import _extract_sift_jit

    def pool_bytes():
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) != (0, 0))

    def captured(fn, program_fn):
        torch.cuda.synchronize()
        before = pool_bytes()
        out = fn()
        torch.cuda.synchronize()
        newest = next(reversed(program_fn.programs.values()))
        static = sum(t.numel() * t.element_size() for t in jit.tensors(newest.static))
        return out, dict(pool_mb=(pool_bytes() - before) / 2**20, static_mb=static / 2**20)

    pools = {}
    da0, pools["extract_sift"] = captured(lambda: ct.extract_sift(img_a, params),
                                          _extract_sift_jit)
    db0 = ct.extract_sift(img_b, params)
    m0 = ct.match_sift_data(da0, db0)
    (h0, _), pools["find_homography"] = captured(
        lambda: ct.find_homography(m0, gen, **hom_kw), homography_ops._find_homography_jit)
    _, pools["improve_homography"] = captured(
        lambda: ct.improve_homography(m0, h0, *irls_args),
        homography_ops._improve_homography_jit)
    require(all(p["pool_mb"] > 0 for p in pools.values()), f"a program has no pool: {pools}")
    log(f"programs' memory (MB: private pool, static input copies): {json.dumps(pools)}")
    del da0, db0, m0, h0

    timings = {"programs_memory_mb": pools}

    def run_flow(label, fparams, pair, path, absent=(), gate_homography=True, time_fit=False):
        """Drive the demo flow once on a frame ``pair`` with every launch
        counter at 0, require each kernel of ``path`` launched and none of
        ``absent``, gate the results (the corner error only with
        ``gate_homography``), hold the two extractions (replayed from their
        captured program) against the eager run and RANSAC and IRLS
        (replayed, behind the eager matching) against theirs, and time
        extraction both ways and matching; with ``time_fit`` also matching
        (eager) and RANSAC and IRLS both ways with their kernels and the
        device's busy share."""
        torch.cuda.synchronize()
        for k in KERNELS + HOMOGRAPHY:
            k.launches = 0
        da, db, m, h1, nm, h2, nfit, err = demo_flow(fparams, *pair)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS + HOMOGRAPHY}
        log(f"{label} launches: { {k.name: k.launches for k in LIBRARY} }")
        require(all(k.launches > 0 for k in path) and not any(k.launches for k in absent),
                f"{label}: wrong kernels launched: {launches}")

        for name, d in (("A", da), ("B", db)):
            n = int(d.num_pts)
            require(n > 0, f"{label}: frame {name} has no keypoints")
            for f in ("xpos", "ypos", "scale", "orientation", "data"):
                require(bool(torch.isfinite(getattr(d, f)[:n]).all()),
                        f"{label}: frame {name} {f} not finite")
        n_a = int(da.num_pts)
        matched = int(((m.ambiguity[:n_a] < 0.8) & (m.score[:n_a] > 0.0)).sum())
        err1 = synth.corner_error(h1.cpu().numpy(), h_true, H, W)
        err2 = synth.corner_error(h2.cpu().numpy(), h_true, H, W)
        require(err2 < 1.0 or not gate_homography,
                f"{label}: refined homography corner error {err2} px >= 1.0")

        # The same two extractions dispatched from the host: every field of
        # both SiftData equal, and the same launches counted.
        with jit.disable_graphs():
            for k in KERNELS:
                k.launches = 0
            ea, eb = ct.extract_sift(pair[0], fparams), ct.extract_sift(pair[1], fparams)
            torch.cuda.synchronize()
            eager_counts = {k.name: k.launches for k in LIBRARY}
        for name, got, ref in (("A", da, ea), ("B", db, eb)):
            for f in ct.SiftData.__dataclass_fields__:
                require(torch.equal(getattr(got, f), getattr(ref, f)),
                        f"{label}: frame {name} {f} differs between the graph and the eager run")
        flow_counts = {k.name: launches[k.name] for k in LIBRARY if k is not match.KERNEL}
        eager_counts.pop(match.KERNEL.name)
        require(flow_counts == eager_counts,
                f"{label}: launches differ, replayed {flow_counts}, eager {eager_counts}")

        # Matching, RANSAC and IRLS replayed from their programs (captured
        # before the first flow; every flow's sets have the same shapes) and
        # dispatched from the host, the generator seeded alike: the flow's,
        # the replayed and the eager outputs equal bit for bit, the same
        # launches counted.
        def fit_counted():
            for k in KERNELS + HOMOGRAPHY:
                k.launches = 0
            out = match_and_fit(da, db)
            torch.cuda.synchronize()
            return out, {k.name: k.launches for k in LIBRARY + HOMOGRAPHY}

        replayed, fit_counts = fit_counted()
        with jit.disable_graphs():
            eager_fit, eager_fit_counts = fit_counted()
        for what, got in (("flow", (m, h1, nm, h2, nfit, err)), ("replayed", replayed)):
            for f in ct.SiftData.__dataclass_fields__:
                require(torch.equal(getattr(got[0], f), getattr(eager_fit[0], f)),
                        f"{label}: matched {f} differs between the {what} and the eager run")
            for name, a, b in zip(("homography", "num_matches", "refined homography", "numFit",
                                   "match_error"), got[1:], eager_fit[1:]):
                require(torch.equal(a, b),
                        f"{label}: {name} differs between the {what} and the eager run")
        require(fit_counts == eager_fit_counts and fit_counts[match.KERNEL.name] == 1
                and fit_counts[ransac.SCORE_KERNEL.name] == 2
                and fit_counts[lstsq.KERNEL.name] == 4,
                f"{label}: match launches differ, replayed {fit_counts}, eager {eager_fit_counts}")
        if time_fit:
            # Each call timed dispatched from the host and replayed, by CUDA
            # events and by the host's clock; kernels and device time from
            # torch.profiler, the busy share over the host-clock time.
            # The programs are captured anew first: torch.profiler sees the
            # kernels of a graph in the first session that traces it only
            # (a second session over the same graph recorded none).
            programs = {"find_homography": homography_ops._find_homography_jit,
                        "improve_homography": homography_ops._improve_homography_jit}
            for program_fn in programs.values():
                program_fn.clear_cache()
            fit_t = {}
            calls = (("match_sift_data", lambda: ct.match_sift_data(da, db)),
                     ("find_homography", lambda: ct.find_homography(m, gen, **hom_kw)),
                     ("improve_homography", lambda: ct.improve_homography(m, h1, *irls_args)))
            for name, fn in calls:
                with jit.disable_graphs():
                    e = dict(ms=time_ms(fn, iters=3, warmup=1),
                             wall_ms=time_fn(fn, iters=3, warmup=0), **device_kernels(fn))
                if name not in programs:        # matching runs eagerly either way
                    e["busy"] = e["device_ms"] / e["wall_ms"]
                    fit_t[name] = dict(eager=e, replayed=e)
                    continue
                r = dict(ms=time_ms(fn, iters=10, warmup=1),
                         wall_ms=time_fn(fn, iters=10, warmup=0), **device_kernels(fn))
                # A replay puts the eager run's kernels on the device. One
                # trace of 2865 kernels once read 2864 replayed: traces that
                # differ are both taken again, the replay on a fresh capture
                # of the same program, at most twice; every (eager, replayed)
                # reading is kept.
                reads = [(e["kernels"], r["kernels"])]
                while reads[-1][0] != reads[-1][1] and len(reads) < 3:
                    programs[name].clear_cache()
                    with jit.disable_graphs():
                        eager_kernels = device_kernels(fn)["kernels"]
                    reads.append((eager_kernels, device_kernels(fn)["kernels"]))
                r["kernel_reads"] = reads
                require(reads[-1][0] == reads[-1][1] > 0,
                        f"{label}: {name}: kernels (eager, replayed) read {reads}")
                for t in (e, r):
                    t["busy"] = t["device_ms"] / t["wall_ms"]
                fit_t[name] = dict(eager=e, replayed=r)
            log(f"{label}: match (eager both ways), RANSAC, IRLS eager / replayed (ms, events | "
                f"host clock; kernels; busy): " + "; ".join(
                    f"{n} {t['eager']['ms']:.3f} | {t['eager']['wall_ms']:.3f} / "
                    f"{t['replayed']['ms']:.3f} | {t['replayed']['wall_ms']:.3f}; "
                    f"{t['eager']['kernels']} / {t['replayed']['kernels']}; "
                    f"{t['eager']['busy']:.3f} / {t['replayed']['busy']:.3f}"
                    for n, t in fit_t.items()))

        # Extraction timed as dispatched from the host and as replayed, each by
        # CUDA events around the call and by the host's clock around call and
        # wait.
        extract = lambda: ct.extract_sift(pair[0], fparams)  # noqa: E731
        with jit.disable_graphs():
            eager_ms = time_ms(extract, iters=5, warmup=1)
            eager_wall = time_fn(extract, iters=5, warmup=1)
        extract_ms = time_ms(extract, iters=5, warmup=1)
        extract_wall = time_fn(extract, iters=5, warmup=1)
        match_ms = time_ms(ct.match_sift_data, da, db, iters=5, warmup=1)
        timings[label] = dict(eager_ms=eager_ms, eager_wall_ms=eager_wall,
                              graph_ms=extract_ms, graph_wall_ms=extract_wall)
        if time_fit:
            timings[label]["fit"] = fit_t
        log(f"{label}: num_pts A {n_a} B {int(db.num_pts)}, overflow A "
            f"{int(da.overflow)} B {int(db.overflow)}, matches (ambiguity < 0.8) "
            f"{matched}, RANSAC inliers {int(nm)}, numFit {int(nfit)}, corner error "
            f"RANSAC {err1:.4f} px refined {err2:.4f} px; graph equal to eager on both "
            f"frames and for RANSAC and IRLS (matching eager), launches equal")
        log(f"{label}: extraction per 1920x1080 frame eager {eager_ms:.3f} ms (events) "
            f"{eager_wall:.3f} ms (host clock), replayed {extract_ms:.3f} ms (events) "
            f"{extract_wall:.3f} ms (host clock); "
            f"match {match_ms:.3f} ms ({n_a} x {int(db.num_pts)} of 32768 slots)")
        return da, db, launches

    _, _, launches = run_flow("main path", params, (img_a, img_b), FUSED_PATH, time_fit=True)

    # ---- 4b. Main path, split --------------------------------------------
    stamp("split and leaves flows")
    # The split flow on the blocks pair, for the record: its exact
    # descriptors pass fewer matches through the 0.8 ratio gate than
    # find_homography's minimum of 8, so its corner error is not gated here.
    # Then both paths on the dead-leaves pair, gated, the split one with the
    # launch counts that go into the kernel table.
    split = dataclasses.replace(params, use_fused=False, use_pallas_compact=True)
    run_flow("split path, blocks", split, (img_a, img_b), SPLIT_PATH,
             absent=(orient_desc.KERNEL,), gate_homography=False)
    leaves = (leaf_a, leaf_b)
    la, lb, leaves_launches = run_flow("fused path, leaves", params, leaves, FUSED_PATH,
                                       time_fit=True)
    # The fused path with K3's fast sampler, gated as the shift flow above.
    _, _, fast_launches = run_flow("fast path, leaves",
                                   dataclasses.replace(params, fast_gradients=True),
                                   leaves, FUSED_PATH)
    sa, sb, split_launches = run_flow("split path, leaves", split, leaves, SPLIT_PATH,
                                      absent=(orient_desc.KERNEL,))
    for k in SPLIT_PATH:
        if k not in FUSED_PATH:
            launches[k.name] = split_launches[k.name]

    stamp("matchers, layers and throughput on the leaves flow")
    # K4 and K5 at the main path's shape: the fused leaves flow's own sets,
    # 32768 slots each. K4 against plain: scores at rtol 1e-5 / atol 1e-6,
    # indices equal but at near-ties (float64 scores of the two picks within
    # 1e-6: each side's float32 sums err by up to about 3e-7). Then both
    # kernels and the library call timed over 50 calls back to back; bounds
    # from the live rows (each kernel reads only those) and the outputs.
    ln1, ln2 = int(la.num_pts), int(lb.num_pts)
    lsets = (la.data, lb.data, la.num_pts, lb.num_pts)
    ls, _, li = match.match_descriptors(*lsets)
    ps, _, pi = match_plain.match_descriptors(*lsets)
    require(torch.allclose(ls, ps, rtol=1e-5, atol=1e-6),
            f"K4 main-path scores differ: max abs {float((ls - ps).abs().max())}")
    nflip, flip_gap = near_ties(la.data.double(), lb.data.double(), li, pi)
    require(flip_gap <= 1e-6, f"K4 main-path picks differ beyond a near-tie: {flip_gap}")
    cap = la.data.shape[0]
    live_bytes = (ln1 + ln2) * 128 * 4
    live_ops = 3 * 2.0 * ln1 * ln2 * 128
    results["match"]["leaves"] = dict(
        loop_ms=time_ms_loop(match.match_descriptors, *lsets, n=50),
        library_loop_ms=time_ms_loop(top2, la.data[:ln1], lb.data, ln2, n=50),
        bound_ms=bound(live_bytes + 3 * cap * 4, live_ops, "tf32")[0])
    results["match_sweep"]["leaves"] = dict(
        loop_ms=time_ms_loop(match.sweep_candidates, *lsets, n=50),
        library_loop_ms=results["match"]["leaves"]["library_loop_ms"],
        bound_ms=bound(live_bytes + cap * 2 * (-(-cap // match_plain.SWEEP_CHUNK)) * 8,
                       live_ops, "bf16")[0])
    log(f"K4 at the main path's shape ({ln1} x {ln2} of {cap} slots): {nflip} indices differ "
        f"at near-ties (gap <= {flip_gap:.3g}), score max abs err "
        f"{float((ls - ps).abs().max()):.3g}; per call over 50: K4 "
        f"{results['match']['leaves']['loop_ms']:.4f} ms, K5 sweep "
        f"{results['match_sweep']['leaves']['loop_ms']:.4f} ms, torch.mm + torch.topk "
        f"{results['match']['leaves']['library_loop_ms']:.4f} ms")

    # RANSAC's scoring kernel on the hypotheses the fused leaves flow's own
    # RANSAC scores, taken from its eager body, cut to the benchmark's 10000
    # (and the refit's rescore, one): counts equal to plain, MSAC sums at
    # rtol 1e-5 (the same terms summed in another order) with the same
    # argmin. Bound: about 30 flop a (hypothesis, live point) pair against
    # 67 TFLOP/s; the live points' 16 bytes, the hypotheses' 32 and 12 bytes
    # out a hypothesis.
    seen = []

    def recorded(*args):
        seen.append(args)
        return ransac.inlier_counts(*args)

    lm = ct.match_sift_data(la, lb)
    homography_ops.inlier_counts = recorded
    try:
        with jit.disable_graphs():
            ct.find_homography(lm, torch.Generator(device=dev).manual_seed(SEED), **hom_kw)
    finally:
        homography_ops.inlier_counts = ransac.inlier_counts
    require(len(seen) == 2, f"RANSAC scored {len(seen)} times, not twice")
    s_args = (seen[0][0][:10000].contiguous(),) + seen[0][1:]
    s_live, s_num = int(s_args[5]), s_args[0].shape[0]
    sc, sm = ransac.inlier_counts(*s_args)
    pc, pm = ransac.inlier_counts_plain(*s_args)
    require(torch.equal(sc, pc), "RANSAC scoring counts differ from plain")
    require(torch.allclose(sm, pm, rtol=1e-5, atol=0.0),
            f"RANSAC scoring MSAC differs: max rel {float(((sm - pm) / pm).abs().max())}")
    require(int(torch.argmin(sm)) == int(torch.argmin(pm)), "RANSAC scoring argmin differs")
    results["ransac_score"] = dict(
        max_abs_err=float((sm - pm).abs().max()), ms=time_ms(ransac.inlier_counts, *s_args),
        graph_ms=time_ms_graph(ransac.inlier_counts, *s_args),
        rescore_graph_ms=time_ms_graph(ransac.inlier_counts, s_args[0][:1], *s_args[1:]),
        plain_ms=time_ms(ransac.inlier_counts_plain, *s_args, iters=5, warmup=1),
        bound=bound(16 * s_live + (32 + 12) * s_num, 30.0 * s_num * s_live),
        library_ms=None, hypotheses=s_num, live=s_live, slots=s_args[1].shape[0])
    log(f"RANSAC scoring, {s_num} hypotheses x {s_live} live of {s_args[1].shape[0]} points: "
        f"single {results['ransac_score']['ms']:.4f} ms, graph-replayed "
        f"{results['ransac_score']['graph_ms']:.4f} ms (rescore "
        f"{results['ransac_score']['rescore_graph_ms']:.4f}), plain "
        f"{results['ransac_score']['plain_ms']:.4f} ms, bound "
        f"{results['ransac_score']['bound'][0]:.4f} ms, MSAC max abs err "
        f"{results['ransac_score']['max_abs_err']:.3g}")

    # The weighted refit (csrc/lstsq8.cu) on the four LO refits of the fused
    # leaves flow's RANSAC (one weighting each), taken from its eager body,
    # and on the first with its weights stacked three times (IRLS's shape):
    # ok equal to the plain QR and a at rtol 1e-4 (the same QR; the order of
    # each sum differs). Bound: each live point's 18 + B floats read once,
    # and the QR's float32 work on its 2 rows a weighting: 56 projections of
    # 4 flop, 8 norms of 2 and 8 normalisations and Q^T b products of 3.
    refits = []

    def recorded_refit(*args):
        refits.append(args)
        return lstsq.weighted_lstsq8(*args)

    homography_ops.weighted_lstsq8 = recorded_refit
    try:
        with jit.disable_graphs():
            ct.find_homography(lm, torch.Generator(device=dev).manual_seed(SEED), **hom_kw)
    finally:
        homography_ops.weighted_lstsq8 = lstsq.weighted_lstsq8
    require([r[2].shape[0] for r in refits] == [1] * 4,
            f"the refit was called with {[r[2].shape[0] for r in refits]} weightings")
    lo_args = refits[0]
    three = lo_args[:2] + (lo_args[2].expand(3, -1).contiguous(),) + lo_args[3:]
    refit_err = 0.0
    for args in refits + [three]:
        a, ok = lstsq.weighted_lstsq8(*args)
        pa, pok = lstsq.weighted_lstsq8_plain(*args)
        require(torch.equal(ok, pok) and bool(ok.any()),
                f"refit ok {ok.tolist()} against plain {pok.tolist()}")
        require(torch.allclose(a, pa, rtol=1e-4, atol=1e-5),
                f"refit differs from plain by {(a - pa).abs().max()}")
        refit_err = max(refit_err, float((a - pa).abs().max()))
    r_live = int(lo_args[5])
    qr_ops = 2 * r_live * (56 * 4 + 8 * 2 + 8 * 3)
    results["lstsq8"] = dict(
        max_abs_err=refit_err, ms=time_ms(lstsq.weighted_lstsq8, *lo_args),
        graph_ms=time_ms_graph(lstsq.weighted_lstsq8, *lo_args),
        three_graph_ms=time_ms_graph(lstsq.weighted_lstsq8, *three),
        plain_ms=time_ms(lstsq.weighted_lstsq8_plain, *lo_args, iters=5, warmup=1),
        plain_graph_ms=time_ms_graph(lstsq.weighted_lstsq8_plain, *lo_args),
        three_plain_graph_ms=time_ms_graph(lstsq.weighted_lstsq8_plain, *three),
        bound=bound(4 * (18 + 1) * r_live, qr_ops),
        three_bound_ms=bound(4 * (18 + 3) * r_live, 3 * qr_ops)[0],
        library_ms=None, live=r_live, slots=lo_args[0].shape[0])
    r = results["lstsq8"]
    log(f"refit, one weighting x {r_live} live of {r['slots']} points: single "
        f"{r['ms']:.4f} ms, graph-replayed {r['graph_ms']:.5f} ms (three weightings "
        f"{r['three_graph_ms']:.5f}), plain {r['plain_ms']:.4f} ms (graph "
        f"{r['plain_graph_ms']:.4f}, three {r['three_plain_graph_ms']:.4f}), "
        f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]}; three {r['three_bound_ms']:.6f}), "
        f"floor {floors['lstsq8']:.5f} ms, max abs err {refit_err:.3g}")

    # ScaleUp on the upscale cell's 1280x960 frame: equal to plain bit for
    # bit. Bound: the frame read once and its upsample written once, 20 bytes
    # an input pixel (8 flop). Graph-replayed, the 100 calls write one pooled
    # output, which the 50 MB L2 can hold: ``flow`` in the benchmark's trace
    # (``upscale_roofline.upscale``) is the kernel between the other stages.
    up_img = torch.as_tensor(synth.make_leaves_image(960, 1280, SEED), device=dev)
    up_got = scale_up.scale_up(up_img)
    up_ref = convolve.scale_up(up_img)
    torch.cuda.synchronize()
    require(torch.equal(up_got, up_ref),
            f"ScaleUp differs from plain: max abs {float((up_got - up_ref).abs().max())}")
    up_px = 960 * 1280
    results["scale_up"] = dict(
        max_abs_err=0.0, ms=time_ms(scale_up.scale_up, up_img),
        loop_ms=time_ms_loop(scale_up.scale_up, up_img, n=100),
        graph_ms=time_ms_graph(scale_up.scale_up, up_img),
        plain_ms=time_ms(convolve.scale_up, up_img),
        plain_graph_ms=time_ms_graph(convolve.scale_up, up_img),
        bound=bound(20 * up_px, 8 * up_px), library_ms=None)
    r = results["scale_up"]
    log(f"ScaleUp at 1280x960: equal to plain; single {r['ms']:.4f} ms, over 100 "
        f"{r['loop_ms']:.4f} ms, graph-replayed {r['graph_ms']:.4f} ms "
        f"({20 * up_px / r['graph_ms'] / 1e9:.2f} TB/s), plain {r['plain_ms']:.4f} ms "
        f"(graph {r['plain_graph_ms']:.4f}), bound {r['bound'][0]:.4f} ms")
    # The upscale cell's extraction at that frame: one ScaleUp launch a call,
    # eager and replayed, the replay equal to the eager run.
    up_params = ct.SiftParams(num_octaves=5, init_blur=1.0, thresh=3.0, max_pts=32768,
                              scale_up=True)
    before = scale_up.KERNEL.launches
    with jit.disable_graphs():
        up_eager = ct.extract_sift(up_img, up_params)
    torch.cuda.synchronize()
    launches["scale_up"] = scale_up.KERNEL.launches - before
    for _ in range(3):
        up_replay = ct.extract_sift(up_img, up_params)
    torch.cuda.synchronize()
    require(launches["scale_up"] == 1 and scale_up.KERNEL.launches - before == 4,
            f"ScaleUp launched {scale_up.KERNEL.launches - before} times in 4 extractions")
    require(all(torch.equal(getattr(up_replay, f), getattr(up_eager, f))
                for f in ct.SiftData.__dataclass_fields__),
            "the upscaled extraction replayed differs from its eager run")
    log(f"upscaled extraction at 1280x960: {int(up_eager.num_pts)} points, overflow "
        f"{int(up_eager.overflow)}, replay equal to eager, one ScaleUp launch a call")

    # Device time of one fused leaves flow (two extractions and one match)
    # without the host's dispatch: K1, K2 and K3 graph-replayed at the shapes
    # of each of frame A's five octaves, fed as the pipeline feeds them, and
    # K4 on the flow's own sets; an extraction's kernels are summed over the
    # octaves and counted twice (frame B taken as frame A). Octave 0 is K3's
    # row at the main path's shape, with its bound.
    octave_rows = []
    for o in range(params.num_octaves):
        obase = leaf_bases[o]
        cap_o = params.candidate_capacity(*obase.shape, o)
        low_o = params.lowest_scale_effective / float(2 ** o)
        k1_o = (obase, taps[o], params.thresh, params.edge_limit)
        odog, omask = dog.dog_and_mask(*k1_o)
        oidx, ocount = detect.compact_mask(omask, cap_o)
        k2_o = (odog, oidx, ocount, params.edge_limit, low_o)
        oc = refine.refine_candidates(*k2_o)
        op = detect.refine_candidates(*k2_o)
        require(all(torch.equal(getattr(oc, f), getattr(op, f))
                    for f in ("xpos", "ypos", "scale", "sharpness", "edgeness", "valid")),
                f"K2 differs from plain at octave {o} {tuple(obase.shape)}")
        k3_o = (obase, oc.xpos, oc.ypos, torch.where(oc.valid, oc.scale, 1.0), oc.valid)
        row = dict(octave=o, shape=list(obase.shape), slots=cap_o, live=int(oc.valid.sum()),
                   dog=time_ms_graph(dog.dog_and_mask, *k1_o),
                   refine=time_ms_graph(refine.refine_candidates, *k2_o),
                   orient_desc=time_ms_graph(orient_desc.orient_and_describe, *k3_o, "shift"))
        if o == 0:
            oh2 = orient_desc.orient_and_describe(*k3_o, "shift")[4]
            for name, mode in (("orient_desc", "shift"), ("orient_desc_fast", "fast")):
                results[name]["leaves"] = dict(
                    live=row["live"],
                    graph_ms=(row["orient_desc"] if mode == "shift" else
                              time_ms_graph(orient_desc.orient_and_describe, *k3_o, mode)),
                    bound_ms=k3_bound(k3_o[1], k3_o[3], k3_o[4], oh2)[0])
        octave_rows.append(row)
    flow_ms = {name: 2 * sum(r[name] for r in octave_rows)
               for name in ("dog", "refine", "orient_desc")}
    flow_ms["match"] = time_ms_graph(match.match_descriptors, *lsets, n=20)
    for name, ms in flow_ms.items():
        results[name]["flow_graph_ms"] = ms
    log(f"K2 equal to plain (every field, torch.equal) at the five octave shapes "
        f"{[tuple(r['shape']) for r in octave_rows]}")
    log(f"fused leaves flow, per octave (graph-replayed ms): {json.dumps(octave_rows)}")
    log(f"fused leaves flow, device time of its kernels without dispatch: "
        f"{sum(flow_ms.values()):.4f} ms = {json.dumps(flow_ms)}; launches of the flow "
        f"{ {k.name: leaves_launches[k.name] for k in FUSED_PATH} }; K3 at octave 0 "
        f"({octave_rows[0]['live']} live of {octave_rows[0]['slots']}): shift "
        f"{results['orient_desc']['leaves']['graph_ms']:.4f} ms, fast "
        f"{results['orient_desc_fast']['leaves']['graph_ms']:.4f} ms, bound "
        f"{results['orient_desc']['leaves']['bound_ms']:.4f} ms")

    # The fused leaves frame layer by layer, each layer's device time without
    # dispatch (graph-replayed 20 times): the pyramid, then per octave K1, the
    # plain compaction, K2 and K3 (summed over the octaves), then the merge
    # (concatenation and compaction into max_pts); what is left of the whole
    # frame's replay (events around one call: input copy, graph, output
    # clones) is the octave glue (candidate fields, scaling, validity masks).
    oct_out = []
    for o in reversed(range(params.num_octaves)):
        obase = leaf_bases[o]
        cap_o = params.candidate_capacity(*obase.shape, o)
        oct_out.append(_extract_octave(obase, taps[o], params, float(2 ** o), cap_o)[:2])

    def merge():
        merged = {k: torch.cat([f[k] for f, _ in oct_out]) for k in oct_out[0][0]}
        return _compact(merged, torch.cat([v for _, v in oct_out]), params.max_pts)

    layers = dict(pyramid=time_ms_graph(octave_bases, leaf_a, n=20),
                  dog=sum(r["dog"] for r in octave_rows),
                  compaction=0.0, refine=sum(r["refine"] for r in octave_rows),
                  orient_desc=sum(r["orient_desc"] for r in octave_rows),
                  merge=time_ms_graph(merge, n=20))
    for o in range(params.num_octaves):
        obase = leaf_bases[o]
        cap_o = params.candidate_capacity(*obase.shape, o)
        _, omask = dog.dog_and_mask(obase, taps[o], params.thresh, params.edge_limit)
        layers["compaction"] += time_ms_graph(detect.compact_mask, omask, cap_o, True, n=20)
    whole = timings["fused path, leaves"]["graph_ms"]
    layers["glue"] = whole - sum(layers.values())
    log(f"fused leaves frame A, device ms by layer (graph-replayed): {json.dumps(layers)}; "
        f"whole frame replayed {whole:.4f} ms")

    # Kernels a frame puts on the device and their summed device time, eager
    # and replayed: the replay must put the eager run's kernels on the
    # device, no more and no fewer.
    for label, fparams in (("fused", params), ("split", split)):
        with jit.disable_graphs():
            eager_k = device_kernels(lambda: ct.extract_sift(leaf_a, fparams))
        graph_k = device_kernels(lambda: ct.extract_sift(leaf_a, fparams))
        require(eager_k["kernels"] > 0, f"{label}: torch.profiler recorded no device kernel")
        require(graph_k["kernels"] == eager_k["kernels"],
                f"{label}: {graph_k['kernels']} kernels replayed, {eager_k['kernels']} eager")
        log(f"{label} leaves frame A, kernels on the device (torch.profiler): eager "
            f"{json.dumps(eager_k)}, replayed {json.dumps(graph_k)}")

    # extract_sift_throughput: four 1920x1080 frames in one program, equal to
    # four single calls field by field, timed against them (host clock around
    # call and wait; frames a second).
    frames4 = torch.stack([leaf_a, leaf_b, img_a, img_b])
    singles = [ct.extract_sift(f, params) for f in frames4]
    for k in KERNELS:
        k.launches = 0
    batch = ct.extract_sift_throughput(frames4, params)      # eager, then captured
    batch = ct.extract_sift_throughput(frames4, params)      # replayed
    torch.cuda.synchronize()
    require(all(k.launches == 2 * 4 * params.num_octaves
                for k in (dog.KERNEL, refine.KERNEL, orient_desc.KERNEL)),
            f"throughput launches { {k.name: k.launches for k in FUSED_PATH} }")
    for i, single in enumerate(singles):
        for f in ct.SiftData.__dataclass_fields__:
            require(torch.equal(getattr(batch, f)[i], getattr(single, f)),
                    f"extract_sift_throughput: frame {i} {f} differs from the single call")
    batch_wall = time_fn(lambda: ct.extract_sift_throughput(frames4, params), iters=5, warmup=1)
    single_wall = time_fn(lambda: [ct.extract_sift(f, params) for f in frames4], iters=5, warmup=1)
    with jit.disable_graphs():
        eager4_wall = time_fn(lambda: ct.extract_sift_throughput(frames4, params), iters=5,
                              warmup=1)
    timings["throughput, 4 frames"] = dict(batch_wall_ms=batch_wall, single_wall_ms=single_wall,
                                           eager_wall_ms=eager4_wall)
    log(f"extract_sift_throughput, 4 frames of 1920x1080 in one program: equal to four single "
        f"calls; {batch_wall:.3f} ms a call = {4e3 / batch_wall:.1f} frames/s, four replayed "
        f"single calls {single_wall:.3f} ms = {4e3 / single_wall:.1f} frames/s, dispatched from "
        f"the host {eager4_wall:.3f} ms = {4e3 / eager4_wall:.1f} frames/s (host clock, points "
        f"{batch.num_pts.tolist()})")

    # ---- 4d. The parallel module at full width -------------------------
    stamp("parallel")
    # The same four frames on a mesh that names the card four times (each
    # shard one frame, run in turn) and on every card there is: both
    # entries equal to the four single calls field by field, with the
    # counters at 0 just before and read just after.
    mesh4 = parallel.Mesh((dev,) * 4)
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    sharded = {"throughput_sharded":
               parallel.extract_sift_throughput_sharded(frames4, params, mesh4)}
    sharded["batched"] = parallel.extract_sift_batched(frames4, params, mesh4)
    sharded["throughput_sharded, all cards"] = parallel.extract_sift_throughput_sharded(
        frames4, params, parallel.make_mesh())
    torch.cuda.synchronize()
    shard_launches = {k.name: k.launches for k in FUSED_PATH}
    require(all(k.launches == 3 * 4 * params.num_octaves
                for k in (dog.KERNEL, refine.KERNEL, orient_desc.KERNEL)),
            f"sharded extraction launches {shard_launches}")
    for what, got in sharded.items():
        for i, single in enumerate(singles):
            for f in ct.SiftData.__dataclass_fields__:
                require(torch.equal(getattr(got, f)[i], getattr(single, f)),
                        f"{what}: frame {i} {f} differs from the single call")
    shard_wall = time_fn(lambda: parallel.extract_sift_throughput_sharded(frames4, params, mesh4),
                         iters=5, warmup=1)
    timings["throughput_sharded, 4 frames, 4-entry mesh"] = dict(wall_ms=shard_wall)
    log(f"parallel, 4 frames of 1920x1080 on a mesh of one card four times and on "
        f"{parallel.make_mesh().size} card(s): throughput_sharded and batched equal to four "
        f"single calls; launches {shard_launches}; {shard_wall:.3f} ms a call (host clock) "
        f"against {batch_wall:.3f} for extract_sift_throughput")

    # The sharded matcher on the fused leaves flow's 32768-slot sets (8192
    # columns a shard, on K4's 1024-column ranges) and on the dry run's
    # 4096 x 16384 unit sets, against single-device K4. Tolerance: indices,
    # best and second equal bit for bit (selections of the same 3xTF32
    # scores), ambiguity within 1e-6 relative. Timed over 20 calls back to
    # back against one K4 call.
    rng_s = np.random.default_rng(SEED)
    s1 = rng_s.standard_normal((4096, 128)).astype(np.float32)
    s2 = rng_s.standard_normal((16384, 128)).astype(np.float32)
    s1 /= np.linalg.norm(s1, axis=1, keepdims=True)
    s2 /= np.linalg.norm(s2, axis=1, keepdims=True)
    sets = {"leaves": lsets,
            "4096x16384": (torch.as_tensor(s1, device=dev), torch.as_tensor(s2, device=dev),
                           torch.tensor(4096, dtype=torch.int32, device=dev),
                           torch.tensor(16384, dtype=torch.int32, device=dev))}
    sharded_match = {}
    for what, sset in sets.items():
        torch.cuda.synchronize()
        match.KERNEL.launches = 0
        shb, shsec, shi = parallel.sharding._match_top2_sharded(*sset, mesh4, 512)
        _, samb, si2 = parallel.match_descriptors_sharded(*sset, mesh4)
        torch.cuda.synchronize()
        require(match.KERNEL.launches == 8, f"sharded matcher on {what}: "
                                            f"{match.KERNEL.launches} K4 launches for 2 x 4 shards")
        rb, rsec, ri = match.match_top2(*sset)
        ra = match.match_descriptors(*sset)[1]
        require(torch.equal(shi, ri) and torch.equal(si2, ri),
                f"sharded matcher on {what}: indices differ on {int((shi != ri).sum())} rows")
        require(torch.equal(shb, rb) and torch.equal(shsec, rsec),
                f"sharded matcher on {what}: best or second differ from single-device K4")
        rel = float(((samb - ra).abs() / ra.abs().clamp(min=1e-30)).max())
        require(rel <= 1e-6, f"sharded matcher on {what}: ambiguity differs by {rel} relative")
        sharded_match[what] = dict(
            ambiguity_max_rel_err=rel, ambiguity_bits_equal=bool(torch.equal(samb, ra)),
            loop_ms=time_ms_loop(parallel.match_descriptors_sharded, *sset, mesh4, n=20),
            single_loop_ms=time_ms_loop(match.match_descriptors, *sset, n=20))
    results["match"]["sharded"] = sharded_match
    log(f"parallel sharded matcher on a 4-entry mesh of one card: indices, best and second equal "
        f"to single-device K4 bit for bit; {json.dumps(sharded_match)}")

    stamp("dry run")
    # The dry run of the whole multi-device flow (a 4-entry mesh over the
    # cards there are), with the counters at 0 just before and read after.
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    dry = dryrun_multichip(4)
    torch.cuda.synchronize()
    dry_launches = {k.name: k.launches for k in FUSED_PATH}
    require(all(n > 0 for n in dry_launches.values()), f"dry run launches {dry_launches}")
    log(f"dry run: {json.dumps(dry)}; launches {dry_launches}")

    # K5 on the split flow's own descriptor sets against K4, with the
    # agreement rule of phase 3.
    for k in KERNELS:
        k.launches = 0
    hyb = match.match_descriptors(sa.data, sb.data, sa.num_pts, sb.num_pts, rescore_k=8)
    torch.cuda.synchronize()
    launches[match.SWEEP_KERNEL.name] = match.SWEEP_KERNEL.launches
    require(match.SWEEP_KERNEL.launches > 0, "K5 did not launch on the split flow's sets")
    ext = match.match_descriptors(sa.data, sb.data, sa.num_pts, sb.num_pts)
    n_sa = int(sa.num_pts)
    dec, same, err5 = k5_agrees(tuple(t[:n_sa] for t in hyb), tuple(t[:n_sa] for t in ext),
                                "split flow")
    log(f"K5 on the split flow ({n_sa} x {int(sb.num_pts)}): {same} of {n_sa} indices "
        f"equal to K4, {dec} rows decided, score err {err5:.3g}")

    # The compaction kernel on and off: bit-identical SiftData.
    plain_compact = ct.extract_sift(leaf_a, dataclasses.replace(split, use_pallas_compact=False))
    for f in ct.SiftData.__dataclass_fields__:
        require(torch.equal(getattr(plain_compact, f), getattr(sa, f)),
                f"use_pallas_compact changes {f}")
    log("split path: use_pallas_compact True and False give bit-identical SiftData")

    # Split against fused with exact descriptors, the JAX package's on-chip
    # bands: keypoint overlap >= 0.98, orientations within 2 deg on >= 95%
    # of position-matched points, descriptor error p99 < 5e-3.
    fused = ct.extract_sift(leaf_a, dataclasses.replace(params, grad_mode="exact"))
    nf = int(fused.num_pts)
    fx, fy, fs, fo = (getattr(fused, f)[:nf].cpu().numpy()
                      for f in ("xpos", "ypos", "scale", "orientation"))
    sx, sy, ss, so = (getattr(sa, f)[:n_sa].cpu().numpy()
                      for f in ("xpos", "ypos", "scale", "orientation"))
    kf = set(zip(np.round(fx, 2), np.round(fy, 2), np.round(fs, 2)))
    kss = set(zip(np.round(sx, 2), np.round(sy, 2), np.round(ss, 2)))
    overlap = len(kf & kss) / max(len(kf), len(kss))
    where_f = {}
    for i, key in enumerate(zip(np.round(fx, 2), np.round(fy, 2))):
        where_f.setdefault(key, []).append(i)
    fdata, sdata = fused.data[:nf].cpu().numpy(), sa.data[:n_sa].cpu().numpy()
    oerr, derr = [], []
    for i, key in enumerate(zip(np.round(sx, 2), np.round(sy, 2))):
        js = where_f.get(key)
        if js is None or len(js) != 1:
            continue
        do = abs(float(fo[js[0]]) - float(so[i]))
        oerr.append(min(do, 360.0 - do))
        derr.append(float(np.abs(fdata[js[0]] - sdata[i]).max()))
    oerr, derr = np.asarray(oerr), np.asarray(derr)
    ori_share = float((oerr < 2.0).mean())
    p99 = float(np.percentile(derr, 99))
    log(f"split vs fused (exact) on leaves frame A: {n_sa} / {nf} points, overlap {overlap:.4f}, "
        f"{len(oerr)} singleton matches, orientations within 2 deg {ori_share:.4f} "
        f"(max {oerr.max():.4g} deg), descriptor error p99 {p99:.3g} max {derr.max():.3g}")
    require(overlap >= 0.98 and len(oerr) > 100 and ori_share >= 0.95 and p99 < 5e-3,
            "split and fused paths disagree beyond the JAX package's bands")

    # ---- 4c. The demo CLI, the acquisition benchmark, the probes ----------
    stamp("CLI, acquisition, probes")
    # The CLI on the card (its default device), in-process, on the
    # dead-leaves pair written as PGM files by the port's writer.
    expected_keys = {"num_pts1", "num_pts2", "overflow1", "overflow2", "num_fit",
                     "num_matches", "match_rate_pct", "first_call_ms", "extract_ms",
                     "match_ms"}
    with tempfile.TemporaryDirectory() as tmp:
        left, right, out_pgm = (os.path.join(tmp, f) for f in ("l.pgm", "r.pgm", "annotated.pgm"))
        write_pgm(left, leaves_a)
        write_pgm(right, leaf_b.cpu().numpy())
        torch.cuda.synchronize()
        for k in KERNELS + HOMOGRAPHY:
            k.launches = 0
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            rc = cli.main(["--left", left, "--right", right, "--thresh", "3.0", "--json",
                           "--time", "--out", out_pgm])
        torch.cuda.synchronize()
        cli_launches = {k.name: k.launches for k in KERNELS + HOMOGRAPHY}
        for line in captured.getvalue().splitlines():
            log(f"cli | {line}")
        require(rc == 0, f"the CLI returned {rc}")
        require(all(k.launches > 0 for k in FUSED_PATH),
                f"CLI: a fused-path kernel did not launch: {cli_launches}")
        metrics = json.loads(captured.getvalue().strip().splitlines()[-1])
        require(set(metrics) == expected_keys, f"CLI JSON keys {sorted(metrics)}")
        require(metrics["num_pts1"] > 0 and metrics["overflow1"] == 0
                and metrics["overflow2"] == 0, f"CLI points or overflow: {metrics}")
        require(metrics["num_fit"] > CLI_MIN_FIT,
                f"CLI numFit {metrics['num_fit']} <= {CLI_MIN_FIT}")
        annotated = read_pgm(out_pgm)
        require(annotated.shape == (H, W), f"annotated image shape {annotated.shape}")
        require(native.have_native(), "the CLI ran without the C++ host codec")
        log(f"CLI on the card: launches { {k.name: k.launches for k in FUSED_PATH} }, "
            f"annotated {annotated.shape} with {int((annotated == 255).sum())} white pixels, "
            f"C++ host codec {native.have_native()}")
    for k in FUSED_PATH + HOMOGRAPHY:
        launches[k.name] = cli_launches[k.name]
    launches["orient_desc_fast"] = fast_launches[orient_desc.KERNEL.name]
    # Launches of one flow (two extractions and a match): the fused leaves
    # flow's for its kernels, the split leaves flow's for the split ones.
    flow_launches = {k.name: leaves_launches[k.name] for k in FUSED_PATH + HOMOGRAPHY}
    flow_launches["orient_desc_fast"] = fast_launches[orient_desc.KERNEL.name]
    for k in SPLIT_PATH:
        if k not in FUSED_PATH:
            flow_launches[k.name] = split_launches[k.name]

    # The acquisition benchmark and the probe runner, each with the counters
    # at 0 just before it and read just after.
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    probes.LAUNCH_FLOOR.launches = 0
    acquire.acquire_bench(*a_args)
    probe_results = probes.run_probes(dev)
    probes.launch_floor(dev)
    torch.cuda.synchronize()
    for k in tuple(acquire.KERNELS.values()) + probes.KERNELS + (probes.LAUNCH_FLOOR,):
        launches[k.name] = k.launches
        require(k.launches > 0, f"{k.name} did not launch in its run")
    for name, (ok, err) in probe_results.items():
        require(ok, f"probe {name} failed (error {err})")
        log(f"PASS {name}: error {err:.3g}")

    rows = []
    by_name = {k.name: k for k in KERNELS + HOMOGRAPHY + UPSCALE + (probes.LAUNCH_FLOOR,)}
    by_name["orient_desc_fast"] = orient_desc.KERNEL
    for name, r in results.items():
        k = by_name[name]
        rows.append({"name": name, "route": "cuda", "source": k.source_path,
                     "replaces": k.replaces, "launches": launches[name],
                     "flow_launches": flow_launches.get(name),
                     "max_abs_err": r.pop("max_abs_err"), "ms": r.pop("ms"),
                     "graph_ms": r.pop("graph_ms"),
                     "plain_ms": r.pop("plain_ms"), "bound_ms": r["bound"][0],
                     "bound_by": r.pop("bound")[1], "library_ms": r.pop("library_ms"),
                     "floor_ms": floors.get(name, floors["one_block"]),
                     **r})   # N-call times, the matchers' main-path shape
    # K1-K8, K3's fast sampler, P1, P2, RANSAC's scoring, ScaleUp and the
    # launch floor.
    n_kernels = len(KERNELS) + len(HOMOGRAPHY) + len(UPSCALE)
    require(len(rows) == n_kernels + 2, f"{len(rows)} kernel rows for {n_kernels} kernels")
    log(f"extraction, matching, RANSAC and IRLS timings (ms): {json.dumps(timings)}")
    log(f"wall time {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
