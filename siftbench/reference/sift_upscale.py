"""The plain reference of SIFT extraction with CudaSift's 2x upscale, in
plain PyTorch.

ExtractSift with ``scaleUp`` set (cudaSiftH.cu:72-232): the frame is
upsampled 2x (ScaleUp, cudaSiftD.cu:170-190) and extracted as a frame of
twice the size, with ``lowestScale`` doubled (cudaSiftH.cu:127); the merged
points' positions and scales are then halved (RescalePositions(0.5),
cudaSiftH.cu:130). The extraction itself is ``reference/sift.py``'s, which
this module wraps; it imports nothing of the measured program.

The upsample keeps the input pixel at the even position of each 2x2 output
block (top-left aligned) and fills the others with the mean of the pixel
and its right neighbour, its down neighbour, or all four of the 2x2
neighbourhood, the right column and bottom row clamped to the edge. It is
written here as gathers by clamped index and strided writes, apart from
the program's concatenations and stacks.

What this reference fixes where upstream's arithmetic or output may
differ, each as the measured program does it:

- the sums are taken left to right in float32, the pixel first, then its
  right, down and down-right neighbours; a kernel that sums them in
  another order differs in the last bit;
- ``subsampling`` is the octave's factor in the upsampled frame and is not
  halved with the positions and scales, so the points of the upsampled
  octave 0 read 1;
- the rest is ``reference/sift.py``'s: raster order, candidates past an
  octave's capacity dropped and counted, and the capacities computed from
  the upsampled octaves' shapes.

``SiftConfig`` adds ``scale_up`` to the package's; at ``scale_up=False``
``extract`` runs the same code with a factor of 1, which is
``reference/sift.py``'s ``extract`` bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from . import sift
from .precision import FLOAT32, Precision


@dataclasses.dataclass(frozen=True)
class SiftConfig(sift.SiftConfig):
    """The extraction settings a configuration file states, ``scale_up``
    among them."""

    scale_up: bool = False

    # What this reference implements of the settings a file may state.
    IMPLEMENTED = {"use_fused": True, "grad_mode": "shift", "fast_gradients": False}


def upsample(img: torch.Tensor) -> torch.Tensor:
    """(2H, 2W): ``img`` (H, W) upsampled 2x, top-left aligned, with the
    right and down neighbours clamped at the edge."""
    h, w = img.shape
    down = torch.clamp(torch.arange(h, device=img.device) + 1, max=h - 1)
    right = torch.clamp(torch.arange(w, device=img.device) + 1, max=w - 1)
    a = img
    r = img[:, right]
    d = img[down, :]
    dr = d[:, right]
    out = torch.empty((2 * h, 2 * w), dtype=img.dtype, device=img.device)
    out[0::2, 0::2] = a
    out[0::2, 1::2] = 0.5 * (a + r)
    out[1::2, 0::2] = 0.5 * (a + d)
    out[1::2, 1::2] = 0.25 * (((a + r) + d) + dr)
    return out


def extract(image: torch.Tensor, cfg: SiftConfig, prec: Precision = FLOAT32) -> sift.Keypoints:
    """Keypoints of one (H, W) float32 frame, on the frame's device, in the
    frame's coordinates."""
    frame = image.to(torch.float32)
    factor = 1.0
    if cfg.scale_up:
        frame = upsample(prec.operand(frame))
        factor = 2.0
    kp = sift.extract(frame, dataclasses.replace(cfg, lowest_scale=cfg.lowest_scale * factor),
                      prec)
    return dataclasses.replace(kp, xpos=kp.xpos / factor, ypos=kp.ypos / factor,
                               scale=kp.scale / factor)
