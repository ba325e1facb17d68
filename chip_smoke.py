#!/usr/bin/env python3
"""Drive the PyTorch port (``cudasift_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles the four kernels from ``cudasift_tpu_torch/csrc``.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the main path on a 1920x1080 frame, with the stated
   tolerances, and both timed with CUDA events.
4. Main path: the reference demo flow on two synthetic 1920x1080 frames
   (frame B is frame A warped by a known homography) -- extract, match,
   RANSAC, refinement -- with every launch counter read after it; the
   refined homography must map the frame corners within 1 px of the truth.

Prints one JSON line with the kernels' numbers, then as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero without that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

H, W = 1080, 1920
SEED = 0


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from cudasift_tpu_torch.ops import convolve, detect
    from cudasift_tpu_torch.ops import match as match_plain
    from cudasift_tpu_torch.ops.cuda import KERNELS, dog, match, orient_desc, refine
    from cudasift_tpu_torch.utils import synth
    from cudasift_tpu_torch.utils.build import build
    from cudasift_tpu_torch.utils.timers import time_ms

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. Build --------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(lambda k: build(k.source, k.flags), KERNELS))
    for k in KERNELS:
        k.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {[p.name for p in libs]}")

    # ---- 3. Each kernel against its plain version ------------------------
    params = ct.SiftParams(num_octaves=5, init_blur=1.0, thresh=3.0, max_pts=32768)
    frame_a = synth.make_test_image(H, W, SEED)
    h_true = synth.known_homography(H, W)
    frame_b = synth.warp_image(frame_a, h_true)
    img_a = torch.as_tensor(frame_a, device=dev)
    img_b = torch.as_tensor(frame_b, device=dev)
    bases = [convolve.low_pass(img_a, params.init_blur)]
    for _ in range(params.num_octaves - 1):
        bases.append(convolve.scale_down(bases[-1]))
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
    results["dog"] = dict(
        max_abs_err=k1_err,
        ms=time_ms(dog.dog_and_mask, base0, taps[0], params.thresh, params.edge_limit),
        plain_ms=time_ms(dog.dog_and_mask_plain, base0, taps[0], params.thresh,
                         params.edge_limit))

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
    results["refine"] = dict(
        max_abs_err=k2_err,
        ms=time_ms(refine.refine_candidates, dog0, flat_idx, count,
                   params.edge_limit, low0),
        plain_ms=time_ms(detect.refine_candidates, dog0, flat_idx, count,
                         params.edge_limit, low0))

    # K3 (shift) on those refined keypoints. Tolerance: orientation median
    # error < 0.2 deg and >= 90% within 2 deg, has2 agreement >= 90%; on the
    # keypoints whose orientations agree (>= 90% of them), descriptor
    # per-row max-abs error median < 4e-3 and max < 2e-2.
    sc = torch.where(got.valid, got.scale, 1.0)
    k3_args = (base0, got.xpos, got.ypos, sc, got.valid, "shift")
    kd1, kd2, ko1, ko2, kh2 = orient_desc.orient_and_describe(*k3_args)
    pd1, pd2, po1, po2, ph2 = orient_desc.orient_and_describe_plain(*k3_args)
    live = got.valid
    nlive = int(live.sum())
    require(nlive > 0, "K3 has no live keypoints")
    dori = (ko1 - po1).abs()[live]
    dori = torch.minimum(dori, 360.0 - dori)
    require(float(dori.median()) < 0.2 and float((dori < 2.0).float().mean()) >= 0.9,
            f"K3 orientations differ: median {float(dori.median())}")
    agree2 = float((kh2 == ph2)[live].float().mean())
    require(agree2 >= 0.9, f"K3 has2 agrees on {agree2}")
    same = live & ((ko1 - po1).abs() < 1e-3)
    require(int(same.sum()) >= 0.9 * nlive, "K3 orientations agree on < 90%")
    rowerr = (kd1 - pd1).abs().max(dim=1).values[same]
    require(float(rowerr.median()) < 4e-3 and float(rowerr.max()) < 2e-2,
            f"K3 descriptors differ: median {float(rowerr.median())}, max {float(rowerr.max())}")
    norms = kd1[live].norm(dim=1)
    require(bool(((norms - 1.0).abs() < 1e-4).all()), "K3 descriptors are not unit length")
    log(f"K3: {nlive} live, orientation median err {float(dori.median()):.3g} deg, "
        f"has2 agreement {agree2:.4f}, descriptor row err median "
        f"{float(rowerr.median()):.3g} max {float(rowerr.max()):.3g}")
    results["orient_desc"] = dict(
        max_abs_err=float(rowerr.max()),
        ms=time_ms(orient_desc.orient_and_describe, *k3_args),
        plain_ms=time_ms(orient_desc.orient_and_describe_plain, *k3_args, iters=5))

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
    results["match"] = dict(
        max_abs_err=k4_err,
        ms=time_ms(match.match_descriptors, d1, d2, 4096, n2),
        plain_ms=time_ms(match_plain.match_descriptors, d1, d2, 4096, n2))

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

    def demo_flow():
        gen.manual_seed(SEED)
        da = ct.extract_sift(img_a, params)
        db = ct.extract_sift(img_b, params)
        m = ct.match_sift_data(da, db)
        h1, nm = ct.find_homography(m, gen, num_loops=10240, min_score=0.0,
                                    max_ambiguity=0.80, thresh=5.0)
        h2, nfit, _ = ct.improve_homography(m, h1, 5, 0.0, 0.80, 3.0)
        return da, db, m, h1, nm, h2, nfit

    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    da, db, m, h1, nm, h2, nfit = demo_flow()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    log(f"main path launches: {launches}")
    require(all(v > 0 for v in launches.values()), f"a kernel did not launch: {launches}")

    for name, d in (("A", da), ("B", db)):
        n = int(d.num_pts)
        require(n > 0, f"frame {name} has no keypoints")
        for f in ("xpos", "ypos", "scale", "orientation", "data"):
            require(bool(torch.isfinite(getattr(d, f)[:n]).all()),
                    f"frame {name} {f} not finite")
    n_a = int(da.num_pts)
    matched = int(((m.ambiguity[:n_a] < 0.8) & (m.score[:n_a] > 0.0)).sum())
    err1 = synth.corner_error(h1.cpu().numpy(), h_true, H, W)
    err2 = synth.corner_error(h2.cpu().numpy(), h_true, H, W)
    require(err2 < 1.0, f"refined homography corner error {err2} px >= 1.0")

    extract_ms = time_ms(ct.extract_sift, img_a, params, iters=5, warmup=1)
    match_ms = time_ms(ct.match_sift_data, da, db, iters=5, warmup=1)
    log(f"main path: num_pts A {n_a} B {int(db.num_pts)}, overflow A "
        f"{int(da.overflow)} B {int(db.overflow)}, matches (ambiguity < 0.8) "
        f"{matched}, RANSAC inliers {int(nm)}, numFit {int(nfit)}, corner error "
        f"RANSAC {err1:.4f} px refined {err2:.4f} px")
    log(f"main path: extraction {extract_ms:.3f} ms per 1920x1080 frame, "
        f"match {match_ms:.3f} ms ({n_a} x {int(db.num_pts)} of 32768 slots)")

    rows = []
    for k in KERNELS:
        r = results[k.name]
        rows.append({"name": k.name, "route": "cuda", "source": k.source_path,
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
