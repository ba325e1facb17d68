"""Data-parallel extraction and the column-sharded matcher on several
devices (the JAX package's ``parallel/sharding.py``).

The JAX package drives its mesh from one Python process (single
controller), and so does the port: a ``Mesh`` is a tuple of
``torch.device``s, and every shard is issued from this process to its
device before any result is gathered, so shards on distinct cards overlap.
There is no ``torch.distributed``: extraction needs no collective (frames
are independent), and the matcher's only one is a gather of 12 bytes a query
and shard, which a device-to-device copy serves.

A mesh may name a device more than once; its shards then run one after
another on that device. That is the counterpart of XLA's virtual host
devices, and lets one card, or the CPU, run real splits and merges.

- ``extract_sift_throughput_sharded``: the batch split into contiguous
  shards, each run through ``pipeline._extract_batch_jit`` on its device
  (one captured program per (shard shape, params, device) on a card), the
  results stacked on the mesh's first device.
- ``match_descriptors_sharded``: the second set's capacity axis split over
  the mesh, the first set replicated; each shard runs the matcher kernel
  (K4) on its slab and returns (best, second, index), merged on the first
  device as the JAX package merges its all-gathered triples.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import SiftParams
from ..ops.cuda.match import match_top2
from ..pipeline import _as_frames, _check_params, _extract_batch_jit
from ..sift_data import SiftData, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a one-axis mesh, in shard order; a device may appear
    more than once."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, device: torch.device | str = "cuda") -> Mesh:
    """The first ``n_devices`` devices of ``device``'s type (all of them
    when None): CUDA cards, or the one CPU. Raises without a card unless
    asked for the CPU, and when there are fewer devices than asked for."""
    kind = resolve_device(device).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"asked for {n} {kind} devices, {count} available")
    devices = [torch.device(kind, i) for i in range(n)] if kind == "cuda" else [torch.device(kind)]
    return Mesh(tuple(devices))


def _stack(parts: list[SiftData], device: torch.device) -> SiftData:
    """Batched ``SiftData`` shards gathered on ``device`` along their
    leading axis."""
    return SiftData(**{name: torch.cat([getattr(p, name).to(device) for p in parts])
                       for name in SiftData.__dataclass_fields__})


def extract_sift_throughput_sharded(images, params: SiftParams, mesh: Mesh) -> SiftData:
    """Data parallel over frames, each device running the throughput
    program (``extract_sift_throughput``'s) on its contiguous shard.

    images: (B, H, W), B divisible by the mesh size; a tensor or an
    array-like. Returns a ``SiftData`` whose fields carry a leading (B,)
    axis, on ``mesh.devices[0]``: the port's reading of JAX's global array
    sharded over the batch.
    """
    # A tensor stays where it is until its shards are copied to their
    # devices; an array-like is staged on the CPU.
    frames = _as_frames(images, None if isinstance(images, torch.Tensor) else "cpu", 3)
    n_dev = mesh.size
    if frames.shape[0] % n_dev:
        raise ValueError(f"batch {frames.shape[0]} not divisible by mesh size {n_dev}")
    per = frames.shape[0] // n_dev
    for dev in set(mesh.devices):
        _check_params(params, dev)
    # Every shard is issued before any result is gathered.
    parts = [_extract_batch_jit(frames[i * per:(i + 1) * per].to(dev), params)
             for i, dev in enumerate(mesh.devices)]
    return _stack(parts, mesh.devices[0])


def extract_sift_batched(images, params: SiftParams, mesh: Mesh | None = None) -> SiftData:
    """Extract SIFT from a batch of same-shaped frames (B, H, W); fields
    carry a leading (B,) axis.

    The JAX package vmaps its pipeline here; the port has no batched form of
    its kernels, so this reaches the same per-device program as
    ``extract_sift_throughput_sharded``: with a mesh it is that function
    (B divisible by the mesh size), and with ``mesh=None`` one program on the
    images' device (``extract_sift_throughput``; array-likes go to the card).
    """
    if mesh is not None:
        return extract_sift_throughput_sharded(images, params, mesh)
    frames = _as_frames(images, None, 3)
    _check_params(params, frames.device)
    return _extract_batch_jit(frames, params)


def match_descriptors_sharded(d1: torch.Tensor, d2: torch.Tensor, n1, n2, mesh: Mesh,
                              tile: int = 512):
    """Brute-force top-2 matching of ``d1`` against ``d2`` with ``d2``'s
    capacity axis split over the mesh and ``d1`` replicated.

    ``d2`` is padded to a multiple of ``mesh.size * tile`` rows, as the JAX
    package pads it. Each shard matches ``d1`` against its slab of the
    second set with the live count ``clamp(n2 - offset, 0, shard)`` (a 0-d
    tensor: no host read) and returns (best, second, index) with the index
    offset to the whole set; the triples are gathered on ``mesh.devices[0]``
    and merged there, the first maximal shard winning so that the lowest
    index wins ties, as on one device. Returns (score, ambiguity, index),
    each (N1,), as ``ops.match.match_descriptors`` does. ``tile`` also
    shapes the plain matcher's column loop on the CPU.
    """
    best, second, index = _match_top2_sharded(d1, d2, n1, n2, mesh, tile)
    return best, second / (best + 1e-6), index


def _match_top2_sharded(d1: torch.Tensor, d2: torch.Tensor, n1, n2, mesh: Mesh, tile: int):
    """``match_descriptors_sharded``'s merged (best, second, index), before
    the division."""
    n_dev = mesh.size
    pad = (-d2.shape[0]) % (n_dev * tile)
    if pad:
        d2 = torch.cat([d2, torch.zeros((pad, d2.shape[1]), dtype=d2.dtype, device=d2.device)])
    shard = d2.shape[0] // n_dev
    n1 = torch.as_tensor(n1, dtype=torch.int32, device=d1.device)
    n2 = torch.as_tensor(n2, dtype=torch.int32, device=d2.device)
    bests, seconds, indices = [], [], []
    for i, dev in enumerate(mesh.devices):
        offset = i * shard
        n2_local = torch.clamp(n2.to(dev) - offset, 0, shard).to(torch.int32)
        best, second, index = match_top2(d1.to(dev), d2[offset:offset + shard].to(dev),
                                         n1.to(dev), n2_local, tile=tile)
        bests.append(best)
        seconds.append(second)
        indices.append(index + offset)
    home = mesh.devices[0]
    bests, seconds, indices = (torch.stack([t.to(home) for t in ts])
                               for ts in (bests, seconds, indices))     # (n_dev, N1)
    win = torch.argmax(bests, dim=0, keepdim=True)                     # first maximal shard
    best = bests.gather(0, win)[0]
    index = indices.gather(0, win)[0]
    others = bests.scatter(0, win, -torch.inf).max(dim=0).values
    second = torch.maximum(others, seconds.max(dim=0).values)
    return torch.clamp(best, min=0.0), torch.clamp(second, min=0.0), torch.clamp(index, min=0)
