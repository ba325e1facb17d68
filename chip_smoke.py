#!/usr/bin/env python3
"""Drive the PyTorch port (``cudasift_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles every kernel source in ``cudasift_tpu_torch/csrc`` (one
   nvcc per source, all at once) and the C++ host codec (g++).
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the main path on a 1920x1080 frame (the matchers at
   4096 x 4096), with the stated tolerances, both timed with CUDA events,
   beside the least time the card could take (``bound_ms``) and, where one
   PyTorch call computes the same function, that call's time
   (``library_ms``; the port never calls it). K3 in its three samplers;
   the patch-acquisition kernels (P1) on the benchmark's own inputs; the
   eight capability probes (P2).
4. Main path, fused: the reference demo flow on two synthetic 1920x1080
   frames (frame B is frame A warped by a known homography) -- extract,
   match, RANSAC, refinement -- with the launch counters set to 0 just
   before it and read just after; the refined homography must map the frame
   corners within 1 px of the truth.
4b. Main path, split: the flow with ``use_fused=False,
   use_pallas_compact=True`` (compaction, orientation-histogram and
   descriptor kernels in place of the fused one) on the blocks pair, its
   corner error recorded but not gated (too few matches pass its ratio
   test); then on a dead-leaves pair (``synth.make_leaves_image``, whose
   ratio test has margin) the fused flow, the fused flow with the ``fast``
   sampler and the split flow, each with the same gates; then the hybrid
   matcher on the split flow's descriptor sets against the exact one, the
   compaction kernel on and off (bit-identical), and split against fused.
4c. The demo CLI (``cudasift_tpu_torch.cli``) on the card, in-process, on
   the dead-leaves pair written as PGM files; then the patch-acquisition
   benchmark and the probe runner, each with the counters at 0.

Prints one JSON line with the kernels' numbers, then as its last line
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

H, W = 1080, 1920
SEED = 0
# The CLI's numFit floor on the dead-leaves pair (frames rounded to PGM,
# thresh 3.0): its first run on an H100 gave 7233; 10% below that.
CLI_MIN_FIT = 6500

# Published peaks of one NVIDIA H100 SXM at its full 700 W limit: device
# memory bytes/s, and dense operations/s by type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12}


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
    from cudasift_tpu_torch import cli
    from cudasift_tpu_torch.ops import convolve, detect
    from cudasift_tpu_torch.ops import match as match_plain
    from cudasift_tpu_torch.ops import orient as orient_plain
    from cudasift_tpu_torch.ops.cuda import (FUSED_PATH, KERNELS, LIBRARY, SPLIT_PATH, acquire,
                                             compact, descriptor, dog, match, orient,
                                             orient_desc, probes, refine)
    from cudasift_tpu_torch.pipeline import _compact
    from cudasift_tpu_torch.utils import native, synth
    from cudasift_tpu_torch.utils.build import build
    from cudasift_tpu_torch.utils.io import read_pgm, write_pgm
    from cudasift_tpu_torch.utils.timers import time_ms

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. Build --------------------------------------------------------
    t0 = time.perf_counter()
    sources = sorted({(k.source, k.flags) for k in KERNELS})
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        codec = pool.submit(native.have_native)
        libs = list(pool.map(lambda sf: build(*sf), sources))
        require(codec.result(), "the C++ host codec did not build (no g++)")
    for k in KERNELS:
        k.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {[p.name for p in libs]} + host codec")

    # ---- 3. Each kernel against its plain version ------------------------
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
    results = {}

    # K1 on the octave-0 base and on octave 2. Tolerance: dog atol 2e-3 /
    # rtol 1e-4, mask symmetric difference <= 1% of the set bits.
    k1_err = 0.0
    for o in (0, 2):
        base = bases[o].contiguous()
        got_dog, got_mask = dog.dog_and_mask(base, taps[o], params.thresh, params.edge_limit)
        ref_dog, ref_mask = dog.dog_and_mask_plain(base, taps[o], params.thresh,
                                                   params.edge_limit)
        torch.cuda.synchronize()
        err = float((got_dog - ref_dog).abs().max())
        require(torch.allclose(got_dog, ref_dog, atol=2e-3, rtol=1e-4),
                f"K1 dog differs at octave {o}: max abs {err}")
        nref = int(ref_mask.sum())
        sym = int((got_mask != ref_mask).sum())
        require(sym <= max(1, nref // 100), f"K1 mask differs at octave {o}: {sym} of {nref}")
        k1_err = max(k1_err, err)
        log(f"K1 octave {o} {tuple(base.shape)}: dog max abs err {err:.3g}, "
            f"mask {nref} set, {sym} differ")
    base0 = bases[0].contiguous()
    # Bound: the base and taps in, 7 DoG planes (f32) and 5 mask planes
    # (bool) out; per pixel 8 blurs of two 9-tap passes (17 operations
    # each), 7 differences, and 5 scales of 26 comparisons plus an edge test
    # of about 10 operations.
    hw = H * W
    results["dog"] = dict(
        max_abs_err=k1_err,
        ms=time_ms(dog.dog_and_mask, base0, taps[0], params.thresh, params.edge_limit),
        plain_ms=time_ms(dog.dog_and_mask_plain, base0, taps[0], params.thresh,
                         params.edge_limit),
        bound=bound(4 * hw + 4 * taps[0].size + 7 * 4 * hw + 5 * hw,
                    hw * (8 * 2 * 17 + 7 + 5 * (26 + 10))),
        library_ms=None)

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
        log(f"K3 {mode}: {nlive} live, orientation median err {float(dori.median()):.3g} deg, "
            f"has2 agreement {agree2:.4f}, descriptor row err median "
            f"{float(rowerr.median()):.3g} max {float(rowerr.max()):.3g}")
        # Bound: positions, scales and the live mask in, each live
        # keypoint's image square (reach 7.96 * scale + 2.5 px) read once,
        # both descriptor tables and the orientations out for every slot;
        # about 6000 operations for a keypoint's orientation and 256 grid
        # samples of about 60 (sampler, magnitude, angle, binning) per
        # descriptor.
        n = got.xpos.shape[0]
        ndesc = nlive + int((kh2 & live).sum())
        nbytes = (13 * n + keypoint_square(sc[live], 2.5, 7.96)
                  + 2 * 128 * 4 * n + 9 * n)
        return dict(max_abs_err=float(rowerr.max()),
                    ms=time_ms(orient_desc.orient_and_describe, *k3_args),
                    plain_ms=time_ms(orient_desc.orient_and_describe_plain, *k3_args, iters=5),
                    bound=bound(nbytes, 6000 * nlive + 256 * 60 * ndesc),
                    library_ms=None)

    results["orient_desc"] = check_k3("shift")
    results["orient_desc_fast"] = check_k3("fast")

    # K4 at 4096 x 4096 with an n2 mask. Tolerance: indices equal, scores
    # at rtol 1e-5.
    rng = np.random.default_rng(SEED)
    d1 = rng.standard_normal((4096, 128)).astype(np.float32)
    d2 = rng.standard_normal((4096, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    d1 = torch.as_tensor(d1, device=dev)
    d2 = torch.as_tensor(d2, device=dev)
    n2 = torch.tensor(4001, dtype=torch.int32, device=dev)
    ks, ka, ki = match.match_descriptors(d1, d2, 4096, n2)
    ps, pa, pi = match_plain.match_descriptors(d1, d2, 4096, n2)
    require(torch.equal(ki, pi), f"K4 indices differ on {int((ki != pi).sum())} rows")
    require(int(ki.max()) < 4001, "K4 matched a masked column")
    require(torch.allclose(ks, ps, rtol=1e-5, atol=1e-6), "K4 scores differ")
    k4_err = float((ks - ps).abs().max())
    log(f"K4: 4096 x 4096 (n2 4001), indices equal, score max abs err {k4_err:.3g}")
    # Bound: both sets in, three (N1,) outputs; 4096 x 4001 x 128
    # multiply-adds in float32 on the CUDA cores. Library: torch.mm and
    # torch.topk(k=2), two calls (no single call computes a top-2 match).
    top2 = lambda a, b, n: torch.topk(torch.mm(a, b[:n].t()), 2, dim=1)  # noqa: E731
    match_bound = bound(2 * 4096 * 128 * 4 + 3 * 4096 * 4, 2.0 * 4096 * 4001 * 128)
    results["match"] = dict(
        max_abs_err=k4_err,
        ms=time_ms(match.match_descriptors, d1, d2, 4096, n2),
        plain_ms=time_ms(match_plain.match_descriptors, d1, d2, 4096, n2),
        bound=match_bound,
        library_ms=time_ms(top2, d1, d2, 4001))

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
    # operation per mask entry. Library: torch.nonzero of the flat mask (it
    # returns every set entry, uncapped, and waits for the host to size its
    # output).
    results["compact"] = dict(
        max_abs_err=0.0,
        ms=time_ms(compact.compact_mask, masks[0], cap0),
        plain_ms=time_ms(detect.compact_mask, masks[0], cap0, True),
        bound=bound(masks[0].numel() + 4 * cap0 + 8, masks[0].numel()),
        library_ms=time_ms(torch.nonzero, masks[0].reshape(-1)))

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
    kh = orient.orientation_histograms(*k6_args)
    ph = orient.orientation_histograms_plain(*k6_args)
    require(nl0 > 0 and torch.allclose(kh, ph, rtol=1e-5, atol=1e-6),
            f"K6 histograms differ: max abs {float((kh - ph).abs().max())}")
    require(not kh[nl0:].any(), "K6 wrote past the count")
    kp1 = orient_plain.histogram_peaks(kh)[0][:nl0]
    pp1 = orient_plain.histogram_peaks(ph)[0][:nl0]
    dp = (kp1 - pp1).abs()
    dp = torch.minimum(dp, 360.0 - dp)
    share6 = float((dp < 1e-3).float().mean())
    require(share6 >= 0.99, f"K6 peaks agree on {share6}")
    k6_err = float((kh - ph).abs().max())
    log(f"K6: {nl0} live of {cap0} slots, histogram max abs err {k6_err:.3g}, "
        f"primary peaks within 1e-3 deg on {share6:.4f}")
    # Bound: positions, scales and the count in, each live keypoint's
    # 17 x 17 image square, the (slots, 36) histograms out; about 40
    # operations for each of 121 samples per live keypoint.
    results["orient"] = dict(
        max_abs_err=k6_err, ms=time_ms(orient.orientation_histograms, *k6_args),
        plain_ms=time_ms(orient.orientation_histograms_plain, *k6_args),
        bound=bound(12 * cap0 + 4 + nl0 * 17 * 17 * 4 + cap0 * 36 * 4, nl0 * 121 * 40),
        library_ms=None)

    # K7 on those keypoints at their K6 orientations. Tolerance: row max-abs
    # error <= 1e-5, unit norms within 1e-4, zeros past the count, two runs
    # bit-identical.
    ori0 = torch.where(pk, orient_plain.histogram_peaks(kh)[0], 0.0)
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
    log("K5: bf16-flip case -> index 40, duplicate tie-break -> index 50")
    # Bound: both sets in, the (N1, 32) candidate scores and columns out;
    # three bfloat16 products of 4096 x 4001 x 128 multiply-adds on the
    # tensor cores. Library: as K4's, torch.mm and torch.topk(k=2), the
    # float32 top-2 that the sweep and its rescore compute.
    nch = -(-4096 // match_plain.SWEEP_CHUNK)
    results["match_sweep"] = dict(
        max_abs_err=k5_err,
        ms=time_ms(match.sweep_candidates, d1, d2, 4096, n2),
        plain_ms=time_ms(match_plain.sweep_candidates, d1, d2, 4096, n2),
        bound=bound(2 * 4096 * 128 * 4 + 4096 * 2 * nch * 8, 3 * 2.0 * 4096 * 4001 * 128,
                    "bf16"),
        library_ms=time_ms(top2, d1, d2, 4001))
    log(f"K5 with its rescore (the whole rescore_k=8 tier): "
        f"{time_ms(match.match_descriptors, d1, d2, 4096, n2, False, 2048, 8):.4f} ms, "
        f"plain {time_ms(match_plain.match_descriptors_hybrid, d1, d2, 4096, n2, 8):.4f} ms")

    # P1 on the benchmark's own inputs (2048 keypoints, a 1136 x 2176
    # frame, seed 0): each variant against its plain version at rtol 1e-5
    # (the summation order differs). Bound: the union of the windows read
    # once (overlapping windows share bytes), the origins (and the used
    # realignments) in, the (256, 8, 128) blocks out; one add per window
    # element.
    a_img, a_oy, a_ox, a_rxy = acquire.bench_inputs(2048, H, W, SEED)
    a_args = tuple(torch.as_tensor(a, device=dev) for a in (a_img, a_oy, a_ox, a_rxy))
    nkp = a_oy.shape[0]
    out_bytes = nkp // acquire.GROUP * 8 * 128 * 4
    for name, staged, roll in acquire.VARIANTS:
        kern = acquire.KERNELS[(staged, roll)]
        got_p = acquire.acquire(*a_args, staged, roll)
        ref_p = acquire.acquire_plain(*a_args, roll)
        require(torch.allclose(got_p, ref_p, rtol=1e-5, atol=0.0),
                f"P1 {name} differs: max rel err "
                f"{float(((got_p - ref_p).abs() / ref_p.abs().clamp(min=1.0)).max())}")
        rows, cols = acquire.window_index(a_args[1], a_args[2], a_args[3], roll, *a_img.shape)
        covered = torch.zeros(a_img.shape, dtype=torch.bool, device=dev)
        covered[rows, cols] = True
        nbytes = 4 * int(covered.sum()) + 8 * nkp + (8 * nkp if roll else 0) + out_bytes
        ms = time_ms(acquire.acquire, *a_args, staged, roll)
        results[kern.name] = dict(
            max_abs_err=float((got_p - ref_p).abs().max()), ms=ms,
            plain_ms=time_ms(acquire.acquire_plain, *a_args, roll),
            bound=bound(nbytes, nkp * acquire.P * acquire.PW), library_ms=None)
        log(f"P1 {name}: {nkp} keypoints, equal to plain at rtol 1e-5, {ms:.4f} ms "
            f"({ms * 1e6 / nkp:.1f} ns per keypoint), bound {results[kern.name]['bound'][0]:.4f} ms "
            f"({int(covered.sum())} distinct window pixels)")

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
        results[p.kernel.name] = dict(
            max_abs_err=perr, ms=time_ms(p.fn, *args),
            plain_ms=time_ms(p.plain, *args), bound=probe_bound(p, args, out),
            library_ms=None if lib is None else time_ms(lib, *args))
        log(f"P2 {p.name} ({p.kernel.name}): check passed (error {err:.3g}), "
            f"against plain {perr:.3g}")

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
    gen = torch.Generator(device=dev)

    def demo_flow(fparams, fa, fb):
        gen.manual_seed(SEED)
        da = ct.extract_sift(fa, fparams)
        db = ct.extract_sift(fb, fparams)
        m = ct.match_sift_data(da, db)
        h1, nm = ct.find_homography(m, gen, num_loops=10240, min_score=0.0,
                                    max_ambiguity=0.80, thresh=5.0)
        h2, nfit, _ = ct.improve_homography(m, h1, 5, 0.0, 0.80, 3.0)
        return da, db, m, h1, nm, h2, nfit

    def run_flow(label, fparams, pair, path, absent=(), gate_homography=True):
        """Drive the demo flow once on a frame ``pair`` with every launch
        counter at 0, require each kernel of ``path`` launched and none of
        ``absent``, gate the results (the corner error only with
        ``gate_homography``), and time extraction and matching."""
        torch.cuda.synchronize()
        for k in KERNELS:
            k.launches = 0
        da, db, m, h1, nm, h2, nfit = demo_flow(fparams, *pair)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS}
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

        extract_ms = time_ms(ct.extract_sift, pair[0], fparams, iters=5, warmup=1)
        match_ms = time_ms(ct.match_sift_data, da, db, iters=5, warmup=1)
        log(f"{label}: num_pts A {n_a} B {int(db.num_pts)}, overflow A "
            f"{int(da.overflow)} B {int(db.overflow)}, matches (ambiguity < 0.8) "
            f"{matched}, RANSAC inliers {int(nm)}, numFit {int(nfit)}, corner error "
            f"RANSAC {err1:.4f} px refined {err2:.4f} px")
        log(f"{label}: extraction {extract_ms:.3f} ms per 1920x1080 frame, "
            f"match {match_ms:.3f} ms ({n_a} x {int(db.num_pts)} of 32768 slots)")
        return da, db, launches

    _, _, launches = run_flow("main path", params, (img_a, img_b), FUSED_PATH)

    # ---- 4b. Main path, split --------------------------------------------
    # The split flow on the blocks pair, for the record: its exact
    # descriptors pass fewer matches through the 0.8 ratio gate than
    # find_homography's minimum of 8, so its corner error is not gated here.
    # Then both paths on the dead-leaves pair, gated, the split one with the
    # launch counts that go into the kernel table.
    split = dataclasses.replace(params, use_fused=False, use_pallas_compact=True)
    run_flow("split path, blocks", split, (img_a, img_b), SPLIT_PATH,
             absent=(orient_desc.KERNEL,), gate_homography=False)
    leaves = (leaf_a, leaf_b)
    run_flow("fused path, leaves", params, leaves, FUSED_PATH)
    # The fused path with K3's fast sampler, gated as the shift flow above.
    _, _, fast_launches = run_flow("fast path, leaves",
                                   dataclasses.replace(params, fast_gradients=True),
                                   leaves, FUSED_PATH)
    sa, sb, split_launches = run_flow("split path, leaves", split, leaves, SPLIT_PATH,
                                      absent=(orient_desc.KERNEL,))
    for k in SPLIT_PATH:
        if k not in FUSED_PATH:
            launches[k.name] = split_launches[k.name]

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
        for k in KERNELS:
            k.launches = 0
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            rc = cli.main(["--left", left, "--right", right, "--thresh", "3.0", "--json",
                           "--time", "--out", out_pgm])
        torch.cuda.synchronize()
        cli_launches = {k.name: k.launches for k in KERNELS}
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
    for k in FUSED_PATH:
        launches[k.name] = cli_launches[k.name]
    launches["orient_desc_fast"] = fast_launches[orient_desc.KERNEL.name]

    # The acquisition benchmark and the probe runner, each with the counters
    # at 0 just before it and read just after.
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    acquire.acquire_bench(*a_args)
    probe_results = probes.run_probes(dev)
    torch.cuda.synchronize()
    for k in tuple(acquire.KERNELS.values()) + probes.KERNELS:
        launches[k.name] = k.launches
        require(k.launches > 0, f"{k.name} did not launch in its run")
    for name, (ok, err) in probe_results.items():
        require(ok, f"probe {name} failed (error {err})")
        log(f"PASS {name}: error {err:.3g}")

    rows = []
    by_name = {k.name: k for k in KERNELS}
    by_name["orient_desc_fast"] = orient_desc.KERNEL
    for name, r in results.items():
        k = by_name[name]
        rows.append({"name": name, "route": "cuda", "source": k.source_path,
                     "replaces": k.replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    require(len(rows) == len(KERNELS) + 1, f"{len(rows)} kernel rows for {len(KERNELS)} kernels")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
