"""One step of the whole multi-device flow, checked against single-device
calls: the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

``python -m cudasift_tpu_torch.parallel.dryrun [N] [--device cpu]`` runs it
on a mesh of N entries (default 4) over the cards there are, round-robin
(one card takes every shard in turn), or on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..config import SiftParams
from ..ops.cuda.match import match_descriptors
from ..ops.homography import find_homography
from ..ops.match import match_sift_data
from ..pipeline import extract_sift
from ..sift_data import SiftData, resolve_device
from .sharding import (Mesh, extract_sift_batched, extract_sift_throughput_sharded,
                       match_descriptors_sharded)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _require_equal(got: SiftData, ref: SiftData, what: str) -> None:
    for f in dataclasses.fields(SiftData):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        _require(torch.equal(a, b.to(a.device)),
                 f"{what}: {f.name} differs from the single-device call")


def _frame(batch: SiftData, i: int) -> SiftData:
    return SiftData(**{f.name: getattr(batch, f.name)[i] for f in dataclasses.fields(SiftData)})


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda") -> dict:
    """Run the multi-device flow once on a mesh of ``n_devices`` entries over
    the available devices of ``device``'s type, round-robin, and raise on
    any mismatch with the single-device calls:

    1. ``extract_sift_batched`` of ``n_devices`` 240x320 frames, each frame
       equal to its own ``extract_sift`` call field by field;
    2. ``extract_sift_throughput_sharded`` of ``2 * n_devices`` frames, the
       first and the last equal to single calls;
    3. ``match_descriptors_sharded`` of 4096 x 16384 unit descriptors, the
       indices equal to the single-device matcher's;
    4. ``find_homography`` (its captured program on a card) on the matched
       first two frames of the batch.

    Returns the numbers it printed.
    """
    kind = resolve_device(device).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    mesh = Mesh(tuple(torch.device(kind, i % count) if kind == "cuda" else torch.device(kind)
                      for i in range(n_devices)))
    home = mesh.devices[0]
    params = SiftParams(num_octaves=3, thresh=3.0, max_pts=1024, min_candidates=512)
    rng = np.random.default_rng(0)

    images = rng.uniform(0, 255, (n_devices, 240, 320)).astype(np.float32)
    batch = extract_sift_batched(images, params, mesh)
    _require(tuple(batch.xpos.shape) == (n_devices, params.max_pts),
             f"batched xpos has shape {tuple(batch.xpos.shape)}")
    for i in range(n_devices):
        _require_equal(_frame(batch, i), extract_sift(images[i], params, device=home),
                       f"batched frame {i}")

    frames = rng.uniform(0, 255, (2 * n_devices, 240, 320)).astype(np.float32)
    tbatch = extract_sift_throughput_sharded(frames, params, mesh)
    for i in (0, 2 * n_devices - 1):
        _require_equal(_frame(tbatch, i), extract_sift(frames[i], params, device=home),
                       f"throughput frame {i}")

    big1 = rng.standard_normal((4096, 128)).astype(np.float32)
    big2 = rng.standard_normal((16384, 128)).astype(np.float32)
    big1 /= np.linalg.norm(big1, axis=1, keepdims=True)
    big2 /= np.linalg.norm(big2, axis=1, keepdims=True)
    b1, b2 = torch.as_tensor(big1, device=home), torch.as_tensor(big2, device=home)
    n1 = torch.tensor(4096, dtype=torch.int32, device=home)
    n2 = torch.tensor(16384, dtype=torch.int32, device=home)
    _, _, index = match_descriptors_sharded(b1, b2, n1, n2, mesh, tile=512)
    _, _, ref_index = match_descriptors(b1, b2, n1, n2, tile=512)
    _require(torch.equal(index, ref_index),
             f"sharded matcher indices differ on {int((index != ref_index).sum())} rows")

    matched = match_sift_data(_frame(batch, 0), _frame(batch, 1 % n_devices))
    gen = torch.Generator(device=home).manual_seed(0)
    h, nm = find_homography(matched, gen, num_loops=64, min_score=0.0,
                            max_ambiguity=0.95, thresh=5.0)
    _require(tuple(h.shape) == (3, 3) and bool(torch.isfinite(h).all()),
             f"homography {h.tolist()}")
    out = dict(devices=[str(d) for d in mesh.devices], num_pts=batch.num_pts.tolist(),
               throughput_num_pts=tbatch.num_pts.tolist(), inliers=int(nm))
    print(f"dryrun_multichip OK: {n_devices} mesh entries on {sorted(set(out['devices']))}, "
          f"batch numPts={out['num_pts']}, sharded match == single device on 4096x16384, "
          f"inliers={out['inliers']}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
