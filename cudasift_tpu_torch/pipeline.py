"""End-to-end SIFT extraction (ExtractSift, cudaSiftH.cu:72-232).

One structure on every device: per octave, smallest first,

1. the DoG kernel (K1): 8 blurs, 7 DoG planes, extremum + edge mask;
2. raster-order compaction of the mask into the octave's candidate
   capacity: plain PyTorch, or the compaction kernel (K8) with
   ``SiftParams(use_pallas_compact=True)``;
3. the refine kernel (K2): subpixel refinement of the live candidates;
4. orientations and descriptors, on one of two paths:

   - fused (``use_fused=True``, the default): the fused orientation +
     descriptor kernel (K3), on refine's validity mask directly (no
     compaction before it);
   - split (``use_fused=False``): refine's survivors front-packed, the
     count-gated orientation kernel (K6: histograms and their peaks),
     primaries and second-peak duplicates compacted into twice the
     capacity, then the count-gated descriptor kernel (K7);
5. primaries then second-peak duplicates, scaled to image coordinates.

The octaves' slots are then merged by one stable compaction into
``max_pts``, with explicit ``overflow`` accounting. On CUDA tensors each
kernel stage launches its hand-written kernel; on CPU tensors it runs the
kernel's plain PyTorch version. No stage reads a count back to the host, so
on CUDA tensors a whole call is one program: ``extract_sift`` and
``extract_sift_throughput`` replay one captured CUDA graph per (shape,
params, device) (``utils.jit.cuda_graph_jit``, in the role of the JAX
package's ``tpu_jit`` programs); inside ``utils.jit.disable_graphs()`` they
dispatch every operation from the host instead.

With ``utils.trace`` on, the body marks its stages: ``extract.pyramid``
(the blurred base, its octaves and the zero overflow count), per octave
``extract.octave`` around ``extract.dog`` (K1), ``extract.compact``
(compaction and its dropped count), ``extract.refine`` (K2) and ``extract.describe`` (K3; on the
split path K6 and K7, each an interval of that name), then
``extract.merge`` (the cross-octave merge and the ``SiftData``). An
octave's self time is its glue: the fields, the scaling, the split path's
compactions and the overflow sum.

Point order matches the reference's octave recursion (cudaSiftH.cu:146-167):
octaves smallest first, within an octave primary orientations before
second-peak duplicates, each block in raster order. ``num_pts`` counts
every extracted point, including the full-resolution octave's duplicates
that the reference's counter leaves out (cudaSiftH.cu:115).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SiftParams
from .ops import convolve, cuda
from .ops.cuda.dog import dog_and_mask
from .ops.cuda.orient_desc import MODES, orient_and_describe
from .ops.cuda.refine import refine_candidates
from .ops.detect import compact_mask, rank_select
from .sift_data import SiftData, resolve_device
from .utils import trace
from .utils.jit import cuda_graph_jit


def _check_params(params: SiftParams, device: torch.device) -> None:
    """Raise ValueError for an unknown sampler and NotImplementedError for a
    setting the port has no path for."""
    if params.grad_mode not in MODES:
        raise ValueError(f"grad_mode must be one of {MODES}, got {params.grad_mode!r}")
    if device.type == "cuda" and not params.use_pallas:
        raise NotImplementedError(
            "use_pallas=False on a CUDA tensor: the port's GPU path is its kernels")


def _compact(fields: dict, valid: torch.Tensor, capacity: int):
    """Stable-compact field tensors by a validity mask into ``capacity``
    slots (deterministic replacement for atomicInc appends,
    cudaSiftD.cu:1420). Returns (fields, count, total)."""
    src, count, total = rank_select(valid, capacity)
    live = torch.arange(capacity, device=valid.device) < count
    out = {}
    for k, v in fields.items():
        g = v[src]
        mask = live.reshape((capacity,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(mask, g, torch.zeros((), dtype=v.dtype, device=v.device))
    return out, count, total


def _extract_octave(base: torch.Tensor, kernels: np.ndarray, params: SiftParams,
                    subsampling: float, capacity: int):
    """One octave (ExtractSiftOctave, cudaSiftH.cu:169-232). Returns
    (fields, slot validity, dropped candidates) with positions in image
    units (cudaSiftD.cu:410-414)."""
    dev = base.device
    with trace.stage("extract.dog", dev):
        dog, mask = dog_and_mask(base, kernels, params.thresh, params.edge_limit)
    with trace.stage("extract.compact", dev):
        if params.use_pallas_compact:
            flat_idx, count, total = cuda.compact.compact_mask(mask, capacity)
        else:
            flat_idx, count, total = compact_mask(mask, capacity, with_total=True)
        oct_overflow = total - count
    with trace.stage("extract.refine", dev):
        cands = refine_candidates(dog, flat_idx, count, params.edge_limit,
                                  params.lowest_scale_effective / subsampling)
    if params.use_fused:
        mode = "fast" if params.fast_gradients else params.grad_mode
        fields, slot_valid = _fused_orient_describe(base, cands, mode)
    else:
        # The split path's descriptors are always exact; it ignores the
        # sampler, as the JAX package's split path does.
        fields, slot_valid = _split_orient_describe(base, cands, capacity)
    for k in ("xpos", "ypos", "scale"):
        fields[k] = fields[k] * subsampling
    fields["subsampling"] = torch.where(slot_valid, subsampling, 0.0)
    return fields, slot_valid, oct_overflow


def _dup(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Primary slots, then their second-peak duplicates."""
    return torch.cat([a, a if b is None else b])


def _fused_orient_describe(base: torch.Tensor, cands, grad_mode: str):
    """Orientations and descriptors on the fused path (K3), on refine's
    validity mask directly. Returns (fields in octave units, slot validity)
    over ``2 * capacity`` slots: primaries then second-peak duplicates, each
    in raster order, with dead slots between live ones."""
    scale_safe = torch.where(cands.valid, cands.scale, 1.0)
    with trace.stage("extract.describe", base.device):
        desc1, desc2, primary, secondary, has_second = orient_and_describe(
            base, cands.xpos, cands.ypos, scale_safe, cands.valid, grad_mode)
    fields = {k: _dup(getattr(cands, k))
              for k in ("xpos", "ypos", "scale", "sharpness", "edgeness")}
    fields["orientation"] = _dup(primary, secondary)
    fields["data"] = torch.cat([desc1, desc2])
    return fields, torch.cat([cands.valid, cands.valid & has_second])


def _split_orient_describe(base: torch.Tensor, cands, capacity: int):
    """Orientations and descriptors on the split path (the JAX package's
    count-gated kernels, cudasift_tpu/pipeline.py:260-347). Returns (fields
    in octave units, slot validity) over ``2 * capacity`` slots: primaries
    then second-peak duplicates, each in raster order, front-packed."""
    f0, live_count, _ = _compact(
        {"xpos": cands.xpos, "ypos": cands.ypos, "scale": cands.scale,
         "sharpness": cands.sharpness, "edgeness": cands.edgeness},
        cands.valid, capacity)
    live = torch.arange(capacity, device=base.device) < live_count
    scale_safe = torch.where(live, f0["scale"], 1.0)
    with trace.stage("extract.describe", base.device):
        _, primary, secondary, has_second = cuda.orient.orientation_peaks(
            base, f0["xpos"], f0["ypos"], scale_safe, live_count)
    fields = {k: _dup(v) for k, v in f0.items()}
    fields["orientation"] = _dup(primary, secondary)
    valid = torch.cat([live, live & has_second])
    # Every candidate may spawn a duplicate: twice the capacity, so
    # duplicates are only ever dropped at the global max_pts clamp.
    desc_cap = 2 * capacity
    fields, count, _ = _compact(fields, valid, desc_cap)
    slot_valid = torch.arange(desc_cap, device=base.device) < count
    desc_scale = torch.where(slot_valid, fields["scale"], 1.0)
    with trace.stage("extract.describe", base.device):
        fields["data"] = cuda.descriptor.extract_descriptors(
            base, fields["xpos"], fields["ypos"], desc_scale, fields["orientation"], count)
    return fields, slot_valid


def _extract(image: torch.Tensor, params: SiftParams) -> SiftData:
    dev = image.device
    with trace.stage("extract.pyramid", dev):
        img = image.to(torch.float32)
        if params.scale_up:
            img = convolve.scale_up(img)
        low = convolve.low_pass(img, max(params.init_blur, 0.001))

        kernels = params.laplace_kernels
        bases = [low]
        for _ in range(params.num_octaves - 1):
            bases.append(convolve.scale_down(bases[-1]))
        overflow = torch.zeros((), dtype=torch.int32, device=dev)

    all_fields, all_valid = [], []
    for o in reversed(range(params.num_octaves)):
        with trace.stage("extract.octave", dev):
            oh, ow = bases[o].shape
            cap = params.candidate_capacity(oh, ow, o)
            fields, valid, oct_overflow = _extract_octave(
                bases[o].contiguous(), kernels[o], params, float(2 ** o), cap)
            all_fields.append(fields)
            all_valid.append(valid)
            overflow = overflow + oct_overflow
    with trace.stage("extract.merge", dev):
        return _merge(all_fields, all_valid, overflow, params, dev)


def _merge(all_fields: list, all_valid: list, overflow: torch.Tensor, params: SiftParams,
           dev: torch.device) -> SiftData:
    """The octaves' slots merged into ``max_pts`` by one stable compaction,
    as a ``SiftData``."""
    merged = {k: torch.cat([f[k] for f in all_fields]) for k in all_fields[0]}
    valid = torch.cat(all_valid)
    merged, num_pts, total = _compact(merged, valid, params.max_pts)
    # The global max_pts clamp (cudaSiftD.cu:1420-1421) counts as overflow.
    overflow = (overflow + total - num_pts).to(torch.int32)
    if params.scale_up:
        # RescalePositions(0.5) (cudaSiftH.cu:130).
        for k in ("xpos", "ypos", "scale"):
            merged[k] = merged[k] * 0.5

    n = params.max_pts

    def z():
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return SiftData(
        num_pts=num_pts,
        xpos=merged["xpos"],
        ypos=merged["ypos"],
        scale=merged["scale"],
        sharpness=merged["sharpness"],
        edgeness=merged["edgeness"],
        orientation=merged["orientation"],
        score=z(),
        ambiguity=z(),
        match=torch.full((n,), -1, dtype=torch.int32, device=dev),
        match_xpos=z(),
        match_ypos=z(),
        match_error=z(),
        subsampling=merged["subsampling"],
        data=merged["data"],
        overflow=overflow,
    )


@cuda_graph_jit
def _extract_sift_jit(image: torch.Tensor, params: SiftParams) -> SiftData:
    return _extract(image, params)


@cuda_graph_jit
def _extract_batch_jit(images: torch.Tensor, params: SiftParams) -> SiftData:
    # The frames one after another inside one program, as the JAX package
    # unrolls them: each keeps its own count-gated stages.
    outs = [_extract(images[i], params) for i in range(images.shape[0])]
    return SiftData(**{
        name: torch.stack([getattr(o, name) for o in outs])
        for name in SiftData.__dataclass_fields__
    })


def _as_frames(images, device, ndim: int) -> torch.Tensor:
    """``images`` as a float32 tensor: a tensor stays on its device unless
    ``device`` is given; anything else goes to ``device``, the card when
    None (``resolve_device``)."""
    if device is not None or not isinstance(images, torch.Tensor):
        device = resolve_device(device)
    t = torch.as_tensor(images, dtype=torch.float32, device=device)
    if t.ndim != ndim:
        what = "a 2-D grayscale image" if ndim == 2 else "(N, H, W) frames"
        raise ValueError(f"expected {what}, got shape {tuple(t.shape)}")
    return t


def extract_sift(image, params: SiftParams = SiftParams(),
                 device: torch.device | str | None = None) -> SiftData:
    """Extract SIFT keypoints + descriptors from one grayscale image.

    ``image``: (H, W) tensor or array-like, float32 grayscale (0..255
    typical). A tensor stays on its device unless ``device`` is given;
    array-likes go to ``device``, the CUDA card when None. Without a card
    that raises: ``device="cpu"`` runs on the CPU (the kernels' plain
    versions). On the card a call replays one captured program per (shape,
    params, device); the first call for such a key runs eagerly and captures.
    """
    with trace.span("extract_sift"):
        img = _as_frames(image, device, 2)
        _check_params(params, img.device)
        return _extract_sift_jit(img, params)


def extract_sift_throughput(images, params: SiftParams = SiftParams(),
                            device: torch.device | str | None = None) -> SiftData:
    """Extract SIFT from N same-shaped frames in one program (on the card,
    one captured graph per (N, shape, params, device) that runs the frames one
    after another); fields carry a leading (N,) batch axis (``num_pts`` has
    shape (N,)). Devices as in ``extract_sift``."""
    with trace.span("extract_sift_throughput"):
        frames = _as_frames(images, device, 3)
        _check_params(params, frames.device)
        return _extract_batch_jit(frames, params)
