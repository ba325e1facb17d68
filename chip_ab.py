#!/usr/bin/env python3
"""Time the K1 (``dog.cu``) and K8 (``compact.cu``) kernels of this checkout
against those of another checkout, in turns, on one CUDA card.

Run from the repository root: ``python3 chip_ab.py OTHER_ROOT``, where
``OTHER_ROOT`` holds an older tree of the repository (for example the parent
commit unpacked with ``git archive``). Both trees' kernels must keep the C
entry points ``dog_and_mask`` and ``compact_mask`` with their present
arguments. The other tree's sources are built from its ``csrc`` and bound
with this tree's argument types; its K8 gets the scratch its own wrapper
sized (one int per 4096 mask entries, which covers any later segment size).

Inputs are those of ``chip_smoke.py``'s kernel table: K1 on the octave-0 base
of the blocks frame A (1920x1080, ``SiftParams(5, 1.0, 3.0, 32768)``) and,
as ``dog_leaves``, of the dead-leaves frame A, K8 on the octave-0 mask of
the dead-leaves frame A into its 5120 slots. Each timer (``time_ms``:
median single call; ``time_ms_loop``: 100 calls back to back;
``time_ms_graph``: 100 calls replayed from one CUDA graph) runs in the
order other, this, this, other; both trees' outputs must equal the plain
version. ``torch.nonzero_static`` and ``torch.nonzero`` are timed in the
same run. Prints the card's name and power limit, then one JSON line.
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
    from cudasift_tpu_torch.ops.cuda import compact, dog
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
        other_k1(ptr(img), table.ctypes.data_as(ctypes.c_void_p), h, w, float(thresh),
                 float(edge_limit), ptr(out), ptr(mask))
        return out, mask

    def other_compact(mask, capacity):
        n = mask.numel()
        dev = mask.device
        seg = torch.empty((max(-(-n // OLD_SEGMENT), 1),), dtype=torch.int32, device=dev)
        idx = torch.empty((capacity,), dtype=torch.int32, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        total = torch.empty((), dtype=torch.int32, device=dev)
        other_k8(ptr(mask), n, int(capacity), ptr(seg), ptr(idx), ptr(count), ptr(total))
        return idx, count, total

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
