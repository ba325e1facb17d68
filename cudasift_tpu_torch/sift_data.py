"""Fixed-capacity keypoint container, as a dataclass of torch tensors.

Structure-of-arrays with the same 16 fields as the JAX package's
``SiftData`` (field names mirror cudaSift.h:6-22). Capacity (``max_pts``)
is the length of every per-point field; ``num_pts`` is a 0-d int32 tensor
on the same device, so no stage needs to read it back to the host. Slots at
or beyond ``num_pts`` are zero. ``overflow`` counts candidates dropped by
any fixed-capacity stage (per-octave candidate caps and the global
``max_pts`` clamp).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SiftData:
    """SoA keypoint set. Per-point fields have a leading ``max_pts`` axis
    (``extract_sift_throughput`` adds a batch axis in front of it)."""

    num_pts: torch.Tensor      # () int32
    xpos: torch.Tensor         # (max_pts,) f32
    ypos: torch.Tensor         # (max_pts,) f32
    scale: torch.Tensor        # (max_pts,) f32
    sharpness: torch.Tensor    # (max_pts,) f32
    edgeness: torch.Tensor     # (max_pts,) f32
    orientation: torch.Tensor  # (max_pts,) f32, degrees
    score: torch.Tensor        # (max_pts,) f32
    ambiguity: torch.Tensor    # (max_pts,) f32
    match: torch.Tensor        # (max_pts,) int32
    match_xpos: torch.Tensor   # (max_pts,) f32
    match_ypos: torch.Tensor   # (max_pts,) f32
    match_error: torch.Tensor  # (max_pts,) f32
    subsampling: torch.Tensor  # (max_pts,) f32
    data: torch.Tensor         # (max_pts, 128) f32 descriptors
    overflow: torch.Tensor     # () int32

    @property
    def max_pts(self) -> int:
        return self.xpos.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.xpos.device

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.max_pts, device=self.device) < self.num_pts


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: ``device``, or the CUDA card when
    None. Raises when that is a CUDA device and no card is present; the CPU
    is taken only when asked for (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available for {dev}; pass device=\"cpu\" to run on the CPU")
    return dev


def init_sift_data(num: int = 1024, device: torch.device | str = "cuda") -> SiftData:
    """Allocate an empty keypoint set (InitSiftData, cudaSiftH.cu:234-249)
    on ``device``: the card unless the caller asks for the CPU."""
    device = resolve_device(device)

    def z():
        return torch.zeros((num,), dtype=torch.float32, device=device)

    return SiftData(
        num_pts=torch.zeros((), dtype=torch.int32, device=device),
        xpos=z(), ypos=z(), scale=z(), sharpness=z(), edgeness=z(),
        orientation=z(), score=z(), ambiguity=z(),
        match=torch.full((num,), -1, dtype=torch.int32, device=device),
        match_xpos=z(), match_ypos=z(), match_error=z(), subsampling=z(),
        data=torch.zeros((num, 128), dtype=torch.float32, device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


def print_sift_data(data: SiftData, max_points: int | None = None) -> None:
    """Structured dump of a point set (PrintSiftData, cudaSiftH.cu:266-302)."""
    n = int(data.num_pts)
    host = {f.name: getattr(data, f.name).cpu().numpy()
            for f in dataclasses.fields(data)}
    for i in range(n if max_points is None else min(n, max_points)):
        print(f"xpos         = {host['xpos'][i]:.2f}")
        print(f"ypos         = {host['ypos'][i]:.2f}")
        print(f"scale        = {host['scale'][i]:.2f}")
        print(f"sharpness    = {host['sharpness'][i]:.2f}")
        print(f"edgeness     = {host['edgeness'][i]:.2f}")
        print(f"orientation  = {host['orientation'][i]:.2f}")
        print(f"score        = {host['score'][i]:.2f}")
        desc = host["data"][i]
        for j in range(8):
            prefix = "data = " if j == 0 else "       "
            row = "".join(
                " .   " if desc[j + 8 * k] < 0.05 else f"{desc[j + 8 * k]:.2f} "
                for k in range(16)
            )
            print(prefix + row)
    print(f"Number of available points: {n}")
    print(f"Number of allocated points: {data.max_pts}")


def ref_style_num_pts(data: SiftData) -> int:
    """numPts as the reference reports it: every point except the trailing
    block of second-orientation duplicates (cudaSiftH.cu:115 reads a counter
    that excludes the full-resolution octave's duplicates)."""
    n = int(data.num_pts)
    xs = data.xpos[:n].cpu().numpy()
    ys = data.ypos[:n].cpu().numpy()
    sc = data.scale[:n].cpu().numpy()
    seen: set = set()
    is_dup = np.zeros(n, bool)
    for i in range(n):
        key = (xs[i], ys[i], sc[i])
        is_dup[i] = key in seen
        seen.add(key)
    k = 0
    while k < n and is_dup[n - 1 - k]:
        k += 1
    return n - k
