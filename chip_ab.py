#!/usr/bin/env python3
"""Time the K1 (``dog.cu``), K8 (``compact.cu``), K3 (``orient_desc.cu``),
K7 (``descriptor.cu``), K2 (``refine.cu``) and K6 (``orient.cu``) kernels of
this checkout against those of another checkout, in turns, on one CUDA card.

Run from the repository root: ``python3 chip_ab.py OTHER_ROOT``, where
``OTHER_ROOT`` holds an older tree of the repository (for example the parent
commit unpacked with ``git archive``). Both trees' kernels must keep the C
entry points ``dog_and_mask``, ``compact_mask``, ``orient_and_describe``,
``extract_descriptors``, ``refine_candidates`` and ``orientation_histograms``
with their present arguments. The other tree's
sources are built from its ``csrc`` (with its own ``sift_common.cuh``) and
bound with this tree's argument types; its K8 gets the scratch its own
wrapper sized (one int per 4096 mask entries, which covers any later
segment size).

Inputs are those of ``chip_smoke.py``'s kernel table: K1 on the octave-0 base
of the blocks frame A (1920x1080, ``SiftParams(5, 1.0, 3.0, 32768)``) and,
as ``dog_leaves``, of the dead-leaves frame A, K8 on the octave-0 mask of
the dead-leaves frame A into its 5120 slots. Each timer (``time_ms``:
median single call; ``time_ms_loop``: 100 calls back to back;
``time_ms_graph``: 100 calls replayed from one CUDA graph) runs in the
order other, this, this, other; both trees' outputs must equal the plain
version. ``torch.nonzero_static`` and ``torch.nonzero`` are timed in the
same run.

K3 runs in its three samplers on the refined octave-0 candidates of the
blocks frame A (the kernel table's shape: few live slots of 5120) and of the
dead-leaves frame A (the main path's shape: a few thousand live), K7 on the
dead-leaves frame's front-packed keypoints at their K6 orientations, as
``chip_smoke.py`` feeds them. Both trees' outputs must lie within
``chip_smoke.py``'s tolerances of the plain versions and repeat bit for bit;
``time_ms_graph`` and ``time_ms_loop`` run in the same order of turns. Last,
K3 ``shift`` graph-replayed on each of the dead-leaves frame's five octaves,
summed over one flow's two extractions (``orient_desc_shift_flow``).

K3's five outputs are also held equal, bit for bit, between the two trees in
every sampler at both shapes (``orient_desc_bits_equal``). K2 runs on the
octave-0 candidates of both frames and must equal the plain version on both
trees; K6 on the dead-leaves frame's front-packed keypoints: the other
tree's histogram-only launch, alone and followed by the plain peak search
(what its split path ran), against this tree's launch with the peaks inside
and its histogram-only launch (``orient_leaves``), every histogram within
rtol 1e-5 of the plain version. Both are timed graph-replayed and back to
back, in the same order of turns.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

H, W = 1080, 1920
SEED = 0
OLD_SEGMENT = 4096       # mask entries per scratch int of the oldest K8 wrapper


def main(argv: list[str]) -> int:
    import torch

    if len(argv) != 1 or not (Path(argv[0]) / "cudasift_tpu_torch" / "csrc").is_dir():
        print("usage: python3 chip_ab.py OTHER_ROOT (a tree with cudasift_tpu_torch/csrc)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    import cudasift_tpu_torch as ct
    from cudasift_tpu_torch.ops import convolve, detect
    from cudasift_tpu_torch.ops import orient as orient_plain
    from cudasift_tpu_torch.ops.cuda import compact, descriptor, dog, orient, orient_desc, refine
    from cudasift_tpu_torch.pipeline import _compact
    from cudasift_tpu_torch.utils import synth
    from cudasift_tpu_torch.utils.build import Kernel, ptr
    from cudasift_tpu_torch.utils.timers import time_ms, time_ms_graph, time_ms_loop

    other_csrc = (Path(argv[0]) / "cudasift_tpu_torch" / "csrc").resolve()
    other_k1 = Kernel(str(other_csrc / "dog.cu"), dog.KERNEL.symbol, dog.KERNEL.argtypes,
                      flags=dog.KERNEL.flags, name="other_dog")
    other_k8 = Kernel(str(other_csrc / "compact.cu"), compact.KERNEL.symbol,
                      compact.KERNEL.argtypes, flags=compact.KERNEL.flags, name="other_compact")

    def other_dog(img, taps, thresh, edge_limit):
        h, w = img.shape
        out = torch.empty((7, h, w), dtype=torch.float32, device=img.device)
        mask = torch.empty((5, h, w), dtype=torch.bool, device=img.device)
        table = taps.astype("float32")
        other_k1(img.device, ptr(img), table.ctypes.data_as(ctypes.c_void_p), h, w, float(thresh),
                 float(edge_limit), ptr(out), ptr(mask))
        return out, mask

    def other_compact(mask, capacity):
        n = mask.numel()
        dev = mask.device
        seg = torch.empty((max(-(-n // OLD_SEGMENT), 1),), dtype=torch.int32, device=dev)
        idx = torch.empty((capacity,), dtype=torch.int32, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        total = torch.empty((), dtype=torch.int32, device=dev)
        other_k8(dev, ptr(mask), n, int(capacity), ptr(seg), ptr(idx), ptr(count), ptr(total))
        return idx, count, total

    other_k3 = Kernel(str(other_csrc / "orient_desc.cu"), orient_desc.KERNEL.symbol,
                      orient_desc.KERNEL.argtypes, flags=orient_desc.KERNEL.flags,
                      name="other_orient_desc")
    other_k7 = Kernel(str(other_csrc / "descriptor.cu"), descriptor.KERNEL.symbol,
                      descriptor.KERNEL.argtypes, flags=descriptor.KERNEL.flags,
                      name="other_descriptor")

    def other_orient_desc(img, xpos, ypos, scale, live, mode):
        h, w = img.shape
        n = xpos.shape[0]
        desc1 = torch.empty((n, 128), dtype=torch.float32, device=img.device)
        desc2 = torch.empty((n, 128), dtype=torch.float32, device=img.device)
        ori1 = torch.empty((n,), dtype=torch.float32, device=img.device)
        ori2 = torch.empty((n,), dtype=torch.float32, device=img.device)
        has2 = torch.empty((n,), dtype=torch.bool, device=img.device)
        other_k3(img.device, ptr(img), h, w, ptr(xpos), ptr(ypos), ptr(scale), ptr(live), n,
                 orient_desc.MODES.index(mode), ptr(desc1), ptr(desc2), ptr(ori1), ptr(ori2),
                 ptr(has2))
        return desc1, desc2, ori1, ori2, has2

    other_k2 = Kernel(str(other_csrc / "refine.cu"), "refine_candidates",
                      refine.KERNEL.argtypes, flags=refine.KERNEL.flags, name="other_refine")
    # The histogram-only entry point, which both trees export.
    hist_argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int, ctypes.c_void_p]
    other_k6 = Kernel(str(other_csrc / "orient.cu"), "orientation_histograms", hist_argtypes,
                      flags=orient.KERNEL.flags, name="other_orient")

    def other_refine(dog_stack, flat_idx, count, edge_limit, lowest_scale):
        _, h, w = dog_stack.shape
        k = flat_idx.shape[0]
        fields = torch.empty((5, k), dtype=torch.float32, device=dog_stack.device)
        valid = torch.empty((k,), dtype=torch.bool, device=dog_stack.device)
        other_k2(dog_stack.device, ptr(dog_stack), ptr(flat_idx), ptr(count), k, h, w,
                 float(edge_limit), float(lowest_scale), ptr(fields), ptr(valid))
        return detect.Candidates(*fields, valid=valid)

    def other_orient(img, xpos, ypos, scale, count):
        h, w = img.shape
        n = xpos.shape[0]
        hist = torch.empty((n, 32), dtype=torch.float32, device=img.device)
        other_k6(img.device, ptr(img), h, w, ptr(xpos), ptr(ypos), ptr(scale), ptr(count), n,
                 ptr(hist))
        return hist

    def other_orient_peaks(img, xpos, ypos, scale, count):
        hist = other_orient(img, xpos, ypos, scale, count)
        return (hist,) + tuple(orient_plain.histogram_peaks(hist))

    def other_descriptor(img, xpos, ypos, scale, orientation, count):
        h, w = img.shape
        n = xpos.shape[0]
        desc = torch.empty((n, 128), dtype=torch.float32, device=img.device)
        other_k7(img.device, ptr(img), h, w, ptr(xpos), ptr(ypos), ptr(scale),
                 ptr(orientation), ptr(count), n, ptr(desc))
        return desc

    dev = torch.device("cuda", 0)
    params = ct.SiftParams(num_octaves=5, init_blur=1.0, thresh=3.0, max_pts=32768)
    taps = params.laplace_kernels
    base = convolve.low_pass(torch.as_tensor(synth.make_test_image(H, W, SEED), device=dev),
                             params.init_blur).contiguous()
    leaves = convolve.low_pass(torch.as_tensor(synth.make_leaves_image(H, W, SEED), device=dev),
                               params.init_blur).contiguous()
    k1_args = (base, taps[0], params.thresh, params.edge_limit)
    k1_leaves = (leaves, taps[0], params.thresh, params.edge_limit)
    _, mask = dog.dog_and_mask(*k1_leaves)
    cap = params.candidate_capacity(H, W, 0)
    k8_args = (mask, cap)

    ref1 = dog.dog_and_mask_plain(*k1_args)
    ref8 = detect.compact_mask(mask, cap, with_total=True)
    ref1_leaves = dog.dog_and_mask_plain(*k1_leaves)
    for name, fn, args, ref in (("K1 other", other_dog, k1_args, ref1),
                                ("K1 this", dog.dog_and_mask, k1_args, ref1),
                                ("K1 other, leaves", other_dog, k1_leaves, ref1_leaves),
                                ("K1 this, leaves", dog.dog_and_mask, k1_leaves, ref1_leaves),
                                ("K8 other", other_compact, k8_args, ref8),
                                ("K8 this", compact.compact_mask, k8_args, ref8)):
        got = fn(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise RuntimeError(f"chip_ab: {name} differs from the plain version")
    print(f"K1 and K8 of both trees equal their plain versions; mask {mask.numel()} entries, "
          f"{int(ref8[2])} set, {cap} slots", flush=True)

    timers = {"ms": lambda f, a: time_ms(f, *a),
              "loop_ms": lambda f, a: time_ms_loop(f, *a, n=100),
              "graph_ms": lambda f, a: time_ms_graph(f, *a, n=100)}
    out = {"device": torch.cuda.get_device_name(0), "smi": smi}
    for kernel, this_fn, other_fn, args in (("dog", dog.dog_and_mask, other_dog, k1_args),
                                            ("dog_leaves", dog.dog_and_mask, other_dog,
                                             k1_leaves),
                                            ("compact", compact.compact_mask, other_compact,
                                             k8_args)):
        row = {}
        for tname, timer in timers.items():
            turns = [("other", other_fn), ("this", this_fn), ("this", this_fn),
                     ("other", other_fn)]
            for side, fn in turns:
                row.setdefault(f"{side}_{tname}", []).append(timer(fn, args))
        out[kernel] = row
        print(f"{kernel}: {json.dumps(row)}", flush=True)
    # K3 and K7. Octave-0 candidates of a base, refined as the pipeline
    # refines them; the fused path hands K3 the validity mask, the split path
    # front-packs for K7.
    def candidates(octave_base, o=0):
        cap_o = params.candidate_capacity(*octave_base.shape, o)
        dog_o, mask_o = dog.dog_and_mask(octave_base, taps[o], params.thresh, params.edge_limit)
        idx, count = detect.compact_mask(mask_o, cap_o)
        c = refine.refine_candidates(dog_o, idx, count, params.edge_limit,
                                     params.lowest_scale_effective / float(2 ** o))
        return c, (octave_base, c.xpos, c.ypos, torch.where(c.valid, c.scale, 1.0), c.valid)

    def check_k3(name, fn, args, mode):
        got = fn(*args, mode)
        ref = orient_desc.orient_and_describe_plain(*args, mode)
        torch.cuda.synchronize()
        live = args[4]
        dori = (got[2] - ref[2]).abs()[live]
        dori = torch.minimum(dori, 360.0 - dori)
        same = live & ((got[2] - ref[2]).abs() < 1e-3)
        rowerr = (got[0] - ref[0]).abs().max(dim=1).values[same]
        norms = got[0][live].norm(dim=1)
        ok = (float(dori.median()) < 0.2 and float((dori < 2.0).float().mean()) >= 0.9
              and float((got[4] == ref[4])[live].float().mean()) >= 0.9
              and int(same.sum()) >= 0.9 * int(live.sum())
              and float(rowerr.median()) < 4e-3 and float(rowerr.max()) < 2e-2
              and bool(((norms - 1.0).abs() < 1e-4).all())
              and not got[0][~live].any() and not got[1][~(live & got[4])].any()
              and all(torch.equal(a, b) for a, b in zip(got, fn(*args, mode))))
        if not ok:
            raise RuntimeError(f"chip_ab: {name} ({mode}) is outside the tolerances")
        return float(rowerr.max())

    def check_k7(name, fn, args):
        got = fn(*args)
        ref = descriptor.extract_descriptors_plain(*args)
        torch.cuda.synchronize()
        nl = int(args[5])
        err = float((got - ref).abs().max())
        if not (err <= 1e-5 and bool(((got[:nl].norm(dim=1) - 1.0).abs() < 1e-4).all())
                and not got[nl:].any() and torch.equal(got, fn(*args))):
            raise RuntimeError(f"chip_ab: {name} is outside the tolerances (max abs {err})")
        return err

    _, k3_blocks = candidates(base)
    lc, k3_leaves = candidates(leaves)
    f0, live0, _ = _compact({"xpos": lc.xpos, "ypos": lc.ypos, "scale": lc.scale}, lc.valid, cap)
    packed = torch.arange(cap, device=dev) < live0
    sc0 = torch.where(packed, f0["scale"], 1.0)
    hist = orient.orientation_histograms(leaves, f0["xpos"], f0["ypos"], sc0, live0)
    ori0 = torch.where(packed, orient_plain.histogram_peaks(hist)[0], 0.0)
    k7_args = (leaves, f0["xpos"], f0["ypos"], sc0, ori0, live0)

    timers2 = {"graph_ms": timers["graph_ms"], "loop_ms": timers["loop_ms"]}
    cases = []
    for shape, args in (("blocks", k3_blocks), ("leaves", k3_leaves)):
        out[f"live_{shape}"] = int(args[4].sum())
        for mode in orient_desc.MODES:
            errs = [check_k3(f"K3 {side}, {shape}", fn, args, mode)
                    for side, fn in (("other", other_orient_desc),
                                     ("this", orient_desc.orient_and_describe))]
            cases.append((f"orient_desc_{mode}_{shape}", orient_desc.orient_and_describe,
                          other_orient_desc, args + (mode,), errs))
    # K3 of the two trees against each other: every output equal.
    bits = {}
    for shape, args in (("blocks", k3_blocks), ("leaves", k3_leaves)):
        for mode in orient_desc.MODES:
            this = orient_desc.orient_and_describe(*args, mode)
            other = other_orient_desc(*args, mode)
            bits[f"{mode}_{shape}"] = all(torch.equal(a, b) for a, b in zip(this, other))
    out["orient_desc_bits_equal"] = bits
    print(f"orient_desc_bits_equal: {json.dumps(bits)}", flush=True)
    if not all(bits.values()):
        raise RuntimeError("chip_ab: K3's outputs differ between the two trees")

    errs = [check_k7(f"K7 {side}", fn, k7_args)
            for side, fn in (("other", other_descriptor), ("this", descriptor.extract_descriptors))]
    cases.append(("descriptor_leaves", descriptor.extract_descriptors, other_descriptor, k7_args,
                  errs))
    print(f"K3 (three samplers, {out['live_blocks']} and {out['live_leaves']} live of {cap}) and "
          f"K7 ({int(live0)} live) of both trees within the tolerances and deterministic",
          flush=True)
    for kernel, this_fn, other_fn, args, errs in cases:
        row = {"other_max_abs_err": errs[0], "this_max_abs_err": errs[1]}
        for tname, timer in timers2.items():
            for side, fn in (("other", other_fn), ("this", this_fn), ("this", this_fn),
                             ("other", other_fn)):
                row.setdefault(f"{side}_{tname}", []).append(timer(fn, args))
        out[kernel] = row
        print(f"{kernel}: {json.dumps(row)}", flush=True)

    # K2 on the octave-0 candidates of both frames, K6 on the dead-leaves
    # frame's front-packed keypoints.
    def k2_args(octave_base):
        dog_o, mask_o = dog.dog_and_mask(octave_base, taps[0], params.thresh, params.edge_limit)
        idx, count = detect.compact_mask(mask_o, cap)
        return (dog_o, idx, count, params.edge_limit, params.lowest_scale_effective)

    fields = ("xpos", "ypos", "scale", "sharpness", "edgeness", "valid")
    for shape, octave_base in (("blocks", base), ("leaves", leaves)):
        args = k2_args(octave_base)
        ref = detect.refine_candidates(*args)
        row = {"candidates": int(args[2])}
        for side, fn in (("other", other_refine), ("this", refine.refine_candidates)):
            got = fn(*args)
            torch.cuda.synchronize()
            if not torch.equal(got.valid, ref.valid) or not all(
                    torch.allclose(getattr(got, f), getattr(ref, f), rtol=3e-7, atol=0.0)
                    for f in fields[:5]):
                raise RuntimeError(f"chip_ab: K2 {side} ({shape}) differs from the plain version")
            row[f"{side}_equals_plain"] = all(torch.equal(getattr(got, f), getattr(ref, f))
                                              for f in fields)
        for tname, timer in timers2.items():
            for side, fn in (("other", other_refine), ("this", refine.refine_candidates),
                             ("this", refine.refine_candidates), ("other", other_refine)):
                row.setdefault(f"{side}_{tname}", []).append(timer(fn, args))
        out[f"refine_{shape}"] = row
        print(f"refine_{shape}: {json.dumps(row)}", flush=True)

    k6_args = k7_args[:4] + (live0,)
    ref6 = orient.orientation_histograms_plain(*k6_args)
    row = {"live": int(live0)}
    for side, fn in (("other", other_orient), ("this", orient.orientation_histograms)):
        got = fn(*k6_args)
        torch.cuda.synchronize()
        if not torch.allclose(got, ref6, rtol=1e-5, atol=1e-6) or not torch.equal(
                got, fn(*k6_args)):
            raise RuntimeError(f"chip_ab: K6 {side} differs from the plain version")
        row[f"{side}_max_abs_err"] = float((got - ref6).abs().max())
    turns6 = (("other_hist", other_orient), ("other_hist_plain_peaks", other_orient_peaks),
              ("this_peaks", orient.orientation_peaks), ("this_hist", orient.orientation_histograms),
              ("this_hist", orient.orientation_histograms), ("this_peaks", orient.orientation_peaks),
              ("other_hist_plain_peaks", other_orient_peaks), ("other_hist", other_orient))
    for tname, timer in timers2.items():
        for side, fn in turns6:
            row.setdefault(f"{side}_{tname}", []).append(timer(fn, k6_args))
    out["orient_leaves"] = row
    print(f"orient_leaves: {json.dumps(row)}", flush=True)

    # K3 `shift` over one fused leaves flow: graph-replayed on the candidates
    # of each octave of frame A, summed and counted twice (two frames).
    flow = {"other": [0.0, 0.0], "this": [0.0, 0.0], "live": []}
    octave_base = leaves
    for o in range(params.num_octaves):
        if o:
            octave_base = convolve.scale_down(octave_base).contiguous()
        args = candidates(octave_base, o)[1] + ("shift",)
        flow["live"].append(int(args[4].sum()))
        seen = {"other": 0, "this": 0}
        for side, fn in (("other", other_orient_desc), ("this", orient_desc.orient_and_describe),
                         ("this", orient_desc.orient_and_describe), ("other", other_orient_desc)):
            flow[side][seen[side]] += 2 * timers["graph_ms"](fn, args)
            seen[side] += 1
    out["orient_desc_shift_flow"] = flow
    print(f"orient_desc_shift_flow: {json.dumps(flow)}", flush=True)

    flat = mask.reshape(-1)
    nonzero_static = lambda f: torch.nonzero_static(f, size=cap, fill_value=0)  # noqa: E731
    out["compact"]["nonzero_static_ms"] = time_ms(nonzero_static, flat)
    out["compact"]["nonzero_static_loop_ms"] = time_ms_loop(nonzero_static, flat, n=100)
    out["compact"]["nonzero_static_graph_ms"] = time_ms_graph(nonzero_static, flat, n=100)
    out["compact"]["nonzero_ms"] = time_ms(torch.nonzero, flat)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
