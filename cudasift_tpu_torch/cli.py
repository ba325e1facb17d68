"""Demo driver, the analogue of mainSift.cpp:25-93.

Loads an image pair, extracts SIFT on both, matches, estimates and refines a
homography, prints the same summary statistics as the reference demo, and
writes an annotated match image. Runs on the CUDA card unless
``--device cpu`` is given; without a card and without that flag it raises.

Usage::

    python -m cudasift_tpu_torch.cli --left left.pgm --right righ.pgm \
        --thresh 4.5 --out limg_pts.pgm --json
"""

from __future__ import annotations

import argparse
import json
import time


def _parse_args(argv):
    ap = argparse.ArgumentParser(description="SIFT demo on PyTorch + CUDA")
    # The reference demo's pair, relative to its checkout (mainSift.cpp:36-37).
    ap.add_argument("--left", default="data/left.pgm")
    ap.add_argument("--right", default="data/righ.pgm")
    ap.add_argument("--octaves", type=int, default=5)
    ap.add_argument("--init-blur", type=float, default=1.0)
    ap.add_argument("--thresh", type=float, default=4.5)
    ap.add_argument("--lowest-scale", type=float, default=0.0)
    ap.add_argument("--scale-up", action="store_true")
    ap.add_argument("--max-pts", type=int, default=32768)
    ap.add_argument("--num-loops", type=int, default=10240,
                    help="RANSAC iterations (mainSift.cpp:77 uses 10000)")
    ap.add_argument("--out", default=None, help="annotated output PGM path")
    ap.add_argument("--json", action="store_true", help="emit JSON metrics")
    ap.add_argument("--time", action="store_true", help="benchmark timings")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    import torch

    from . import (SiftParams, extract_sift, find_homography, improve_homography,
                   match_sift_data)
    from .sift_data import resolve_device
    from .utils.io import imread_gray, write_pgm
    from .utils.timers import time_fn
    from .utils.viz import draw_match_data

    device = resolve_device(args.device)
    limg = imread_gray(args.left)
    rimg = imread_gray(args.right)
    print(f"Image size = ({limg.shape[1]},{limg.shape[0]})")

    params = SiftParams(
        num_octaves=args.octaves,
        init_blur=args.init_blur,
        thresh=args.thresh,
        lowest_scale=args.lowest_scale,
        scale_up=args.scale_up,
        max_pts=args.max_pts,
    )

    t0 = time.perf_counter()
    d1 = extract_sift(limg, params, device)
    d2 = extract_sift(rimg, params, device)
    n1, n2 = int(d1.num_pts), int(d2.num_pts)   # waits for the device
    t_extract_first = (time.perf_counter() - t0) * 1e3

    d1 = match_sift_data(d1, d2)
    homography, num_matches = find_homography(
        d1, torch.Generator(device).manual_seed(0), num_loops=args.num_loops,
        min_score=0.0, max_ambiguity=0.80, thresh=5.0,
    )
    homography, num_fit, match_error = improve_homography(
        d1, homography, 5, 0.0, 0.80, 3.0
    )
    d1.match_error = match_error

    rate = 100.0 * int(num_fit) / max(min(n1, n2), 1)
    print(f"Number of original features: {n1} {n2}")
    print(
        f"Number of matching features: {int(num_fit)} {int(num_matches)} "
        f"{rate:.2f}% {args.init_blur} {args.thresh}"
    )
    print("Homography:\n", homography.cpu().numpy().round(5))

    metrics = {
        "num_pts1": n1,
        "num_pts2": n2,
        # Candidates/points dropped by capacity limits; nonzero means raise
        # --max-pts.
        "overflow1": int(d1.overflow),
        "overflow2": int(d2.overflow),
        "num_fit": int(num_fit),
        "num_matches": int(num_matches),
        "match_rate_pct": rate,
        "first_call_ms": t_extract_first,
    }
    if args.time:
        ms = time_fn(lambda: extract_sift(limg, params, device))
        metrics["extract_ms"] = ms
        print(f"SIFT extraction time = {ms:.3f} ms (steady state)")
        ms_m = time_fn(lambda: match_sift_data(d1, d2))
        metrics["match_ms"] = ms_m
        print(f"Matching time = {ms_m:.3f} ms")
    if args.out:
        annotated = draw_match_data(d1, d2, limg)
        write_pgm(args.out, annotated)
        print(f"Wrote {args.out}")
    if args.json:
        print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
