"""P2 wrappers: eight capability probes.

Replace the TPU kernels of ``benchmarks/mosaic_probe.py``, each of which
checks that one feature the batched keypoint kernels need lowers on the
TPU. Each CUDA kernel (``csrc/probes.cu``) does on Hopper what its probe
checks there; each wrapper has its launch count and a plain PyTorch version
that CPU tensors take. ``PROBES`` makes each probe's inputs as the TPU probe
makes them and holds the result to what that probe asserts; ``run_probes``
runs all eight on one device. Beside them ``launch_floor`` launches a kernel
with an empty body: graph-replayed, its time is the least any kernel of that
grid takes on the card, the floor that a launch-bound kernel's time is read
against.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from ...utils.build import Kernel, check, ptr

P_, I_ = ctypes.c_void_p, ctypes.c_int


def _kernel(symbol: str, args: list, line: int) -> Kernel:
    return Kernel("probes.cu", f"probe_{symbol}", args, name=f"probe_{symbol}",
                  replaces=f"benchmarks/mosaic_probe.py:{line}")


SLICE_ROWS = _kernel("slice_rows", [P_, I_, I_, P_, I_, P_], 37)
LANE_LANE_DOT = _kernel("lane_lane_dot", [P_, P_, I_, I_, P_], 61)
SCALE_BY_SCALAR = _kernel("scale_by_scalar", [P_, I_, P_, I_, P_], 76)
TRANSPOSE = _kernel("transpose", [P_, I_, I_, P_], 95)
BLOCK_DIAG = _kernel("block_diag", [P_, I_, I_, P_, I_, I_, P_], 114)
STRIDED_ROWS = _kernel("strided_rows", [P_, I_, I_, I_, I_, P_], 130)
ROLL_COLS = _kernel("roll_cols", [P_, I_, I_, P_, P_], 145)
SMALL_DOT = _kernel("small_dot", [P_, P_, I_, I_, I_, P_], 168)
KERNELS = (SLICE_ROWS, LANE_LANE_DOT, SCALE_BY_SCALAR, TRANSPOSE, BLOCK_DIAG, STRIDED_ROWS,
           ROLL_COLS, SMALL_DOT)
# The empty kernel; it stands for the TPU file's probe() harness (the cost of
# running any kernel) and is no probe of a feature, so it is not in KERNELS.
LAUNCH_FLOOR = Kernel("probes.cu", "probe_launch_floor", [I_, I_], name="probe_launch_floor",
                      replaces="benchmarks/mosaic_probe.py:21")


def launch_floor_plain(device, blocks: int = 1, threads: int = 32) -> None:
    """Plain version of ``launch_floor``: nothing."""


def launch_floor(device: torch.device | str, blocks: int = 1, threads: int = 32) -> None:
    """Launch the empty kernel with ``blocks`` blocks of ``threads`` threads
    on the CUDA ``device``; on the CPU there is nothing to launch."""
    device = torch.device(device)
    if not 1 <= threads <= 1024 or blocks < 1:
        raise ValueError(f"needs blocks >= 1 and 1 <= threads <= 1024, got {blocks}, {threads}")
    if device.type == "cpu":
        return launch_floor_plain(device, blocks, threads)
    if device.type != "cuda":
        raise ValueError(f"kernels take CPU or CUDA tensors, got {device}")
    LAUNCH_FLOOR(device, int(blocks), int(threads))


def _2d(t: torch.Tensor, name: str, dtype=torch.float32):
    if t.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    check(t, name, dtype, tuple(t.shape), t.device)
    return t.shape


def slice_rows_plain(img, off, out_rows: int = 8):
    rows = off[0] + torch.arange(out_rows, device=img.device)
    return img[torch.clamp(rows, 0, img.shape[0] - 1)]


def slice_rows(img: torch.Tensor, off: torch.Tensor, out_rows: int = 8) -> torch.Tensor:
    """Rows ``off[0] .. off[0] + out_rows`` of ``img`` (rows clamped into
    it); ``off`` is a (1,) int32 tensor, read on the device."""
    if img.device.type == "cpu":
        return slice_rows_plain(img, off, out_rows)
    r, c = _2d(img, "img")
    check(off, "off", torch.int32, (1,), img.device)
    out = torch.empty((out_rows, c), dtype=torch.float32, device=img.device)
    SLICE_ROWS(img.device, ptr(img), r, c, ptr(off), out_rows, ptr(out))
    return out


def lane_lane_dot_plain(a, b):
    return a.float() @ b.float().t()


def lane_lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(16, k) bf16 . (n, k)^T bf16 -> (16, n) float32, accumulated in
    float32 (on the tensor cores on the card, both bases on 4 bytes)."""
    if a.device.type == "cpu":
        return lane_lane_dot_plain(a, b)
    m, k = _2d(a, "a", torch.bfloat16)
    n, kb = _2d(b, "b", torch.bfloat16)
    if m != 16 or kb != k or n % 8 or k % 16:
        raise ValueError(f"needs a (16, k) and b (n, k), n % 8 == 0, k % 16 == 0; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if (a.data_ptr() | b.data_ptr()) % 4:
        raise ValueError("a and b must start on 4 bytes (the kernel reads bf16 pairs)")
    out = torch.empty((16, n), dtype=torch.float32, device=a.device)
    LANE_LANE_DOT(a.device, ptr(a), ptr(b), n, k, ptr(out))
    return out


def scale_by_scalar_plain(s, idx: int, x):
    return x * s[idx]


def scale_by_scalar(s: torch.Tensor, idx: int, x: torch.Tensor) -> torch.Tensor:
    """``x * s[idx]``, the scalar read on the device."""
    if x.device.type == "cpu":
        return scale_by_scalar_plain(s, idx, x)
    check(s, "s", torch.float32, (s.shape[0],), x.device)
    if not 0 <= idx < s.shape[0]:
        raise ValueError(f"idx {idx} outside s of length {s.shape[0]}")
    _2d(x, "x")
    out = torch.empty_like(x)
    SCALE_BY_SCALAR(x.device, ptr(s), idx, ptr(x), x.numel(), ptr(out))
    return out


def transpose_plain(x):
    out = torch.empty((x.shape[1], x.shape[0]), dtype=x.dtype, device=x.device)
    out.copy_(x.t())
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    """``x.T`` as a new contiguous tensor."""
    if x.device.type == "cpu":
        return transpose_plain(x)
    r, c = _2d(x, "x")
    out = torch.empty((c, r), dtype=torch.float32, device=x.device)
    TRANSPOSE(x.device, ptr(x), r, c, ptr(out))
    return out


def block_diag_plain(a, b):
    out = torch.zeros((a.shape[0] + b.shape[0], a.shape[1] + b.shape[1]), device=a.device)
    out[:a.shape[0], :a.shape[1]] = a
    out[a.shape[0]:, a.shape[1]:] = b
    return out


def block_diag(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[[a, 0], [0, b]]``."""
    if a.device.type == "cpu":
        return block_diag_plain(a, b)
    ra, ca = _2d(a, "a")
    rb, cb = _2d(b, "b")
    out = torch.empty((ra + rb, ca + cb), dtype=torch.float32, device=a.device)
    BLOCK_DIAG(a.device, ptr(a), ra, ca, ptr(b), rb, cb, ptr(out))
    return out


def strided_rows_plain(x, rows: int, start: int, stride: int):
    out = torch.zeros((rows, x.shape[1]), device=x.device)
    out[start::stride] = x
    return out


def strided_rows(x: torch.Tensor, rows: int, start: int, stride: int) -> torch.Tensor:
    """A zeroed (rows, cols) tensor with ``x`` stored into rows ``start::stride``."""
    if not 0 <= start < stride or x.shape[0] != len(range(start, rows, stride)):
        raise ValueError(f"x has {x.shape[0]} rows; rows {start}::{stride} of {rows} "
                         f"are {len(range(start, rows, stride))}")
    if x.device.type == "cpu":
        return strided_rows_plain(x, rows, start, stride)
    _, c = _2d(x, "x")
    out = torch.empty((rows, c), dtype=torch.float32, device=x.device)
    STRIDED_ROWS(x.device, ptr(x), rows, c, start, stride, ptr(out))
    return out


def roll_cols_plain(x, shift):
    cols = x.shape[1]
    return x[:, (torch.arange(cols, device=x.device) - shift[0]) % cols]


def roll_cols(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``np.roll(x, shift[0], axis=1)``; ``shift`` a (1,) int32 tensor,
    read on the device."""
    if x.device.type == "cpu":
        return roll_cols_plain(x, shift)
    r, c = _2d(x, "x")
    check(shift, "shift", torch.int32, (1,), x.device)
    out = torch.empty_like(x)
    ROLL_COLS(x.device, ptr(x), r, c, ptr(shift), ptr(out))
    return out


def small_dot_plain(a, b):
    return a @ b


def small_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) . (k, n) in float32 (fused multiply-adds on the card)."""
    if a.device.type == "cpu":
        return small_dot_plain(a, b)
    m, k = _2d(a, "a")
    kb, n = _2d(b, "b")
    if kb != k:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)}, {tuple(b.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    SMALL_DOT(a.device, ptr(a), ptr(b), m, k, n, ptr(out))
    return out


# ---- The probes: inputs as mosaic_probe.py makes them, and its checks. ----


def _normal(seed: int, shape):
    return np.random.default_rng(seed).normal(size=shape)


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: ``inputs(device)`` makes the arguments of ``fn`` (the
    wrapper) and ``plain`` (its plain version, any device);
    ``judge(out, args)`` returns (passed, error) by the TPU probe's own
    check."""

    name: str
    kernel: Kernel
    fn: Callable
    plain: Callable
    inputs: Callable
    judge: Callable


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _exact(expect):
    def judge(out, args):
        e = expect(*args)
        err = float(np.abs(out - e).max())
        return bool(np.array_equal(out, e)), err
    return judge


def _arange(n, shape):
    return np.arange(n, dtype=np.float32).reshape(shape)


def _lane_lane_judge(out, args):
    a, b = (t.float().cpu().numpy() for t in args)
    err = float(np.abs(out - a @ b.T).max())
    return err < 0.1, err                   # mosaic_probe.py:67


def _scalar_judge(out, args):
    return bool(out[0, 0] == 3.5 and (out == 3.5).all()), float(np.abs(out - 3.5).max())


def _blockdiag_judge(out, args):
    ok = out[0, 0] == 1 and out[50, 70] == 2 and out[0, 70] == 0 and out[50, 0] == 0
    e = np.zeros((96, 128), np.float32)
    e[:48, :64] = 1.0
    e[48:, 64:] = 2.0
    return bool(ok and np.array_equal(out, e)), float(np.abs(out - e).max())


def _strided_judge(out, args):
    ok = out[3, 0] == 1 and out[11, 0] == 1 and out[4, 0] == 0
    e = np.zeros((128, 128), np.float32)
    e[3::8] = 1.0
    return bool(ok and np.array_equal(out, e)), float(np.abs(out - e).max())


# The TPU probe returns this error without a bound; float32 sums of 256
# products of unit normals carry rounding of order 1e-5.
SMALL_DOT_TOL = 1e-3


def _small_dot_judge(out, args):
    a, b = (t.cpu().numpy().astype(np.float64) for t in args)
    err = float(np.abs(out - a @ b).max())
    return err < SMALL_DOT_TOL, err


PROBES = (
    Probe("unaligned_sublane_slice", SLICE_ROWS, slice_rows, slice_rows_plain,
          lambda d: (_t(_arange(64 * 128, (64, 128)), d), _t([3], d, torch.int32)),
          _exact(lambda img, off: img.cpu().numpy()[3:11])),
    Probe("lane_lane_dot", LANE_LANE_DOT, lane_lane_dot, lane_lane_dot_plain,
          lambda d: (_t(_normal(0, (16, 256)), d, torch.bfloat16),
                     _t(_normal(1, (16, 256)), d, torch.bfloat16)),
          _lane_lane_judge),
    Probe("f32_scalar_prefetch", SCALE_BY_SCALAR,
          lambda s, x: scale_by_scalar(s, 2, x), lambda s, x: scale_by_scalar_plain(s, 2, x),
          lambda d: (_t([1.0, 2.0, 3.5], d), _t(np.ones((8, 128)), d)),
          _scalar_judge),
    Probe("transpose_2d", TRANSPOSE, transpose, transpose_plain,
          lambda d: (_t(_normal(0, (16, 256)), d),),
          _exact(lambda x: x.cpu().numpy().T)),
    Probe("concat_blockdiag", BLOCK_DIAG, block_diag, block_diag_plain,
          lambda d: (_t(np.ones((48, 64)), d), _t(np.full((48, 64), 2.0), d)),
          _blockdiag_judge),
    Probe("sublane_interleave_write", STRIDED_ROWS,
          lambda x: strided_rows(x, 128, 3, 8), lambda x: strided_rows_plain(x, 128, 3, 8),
          lambda d: (_t(np.ones((16, 128)), d),),
          _strided_judge),
    Probe("dyn_roll_cost_shape", ROLL_COLS, roll_cols, roll_cols_plain,
          lambda d: (_t(_arange(48 * 256, (48, 256)), d), _t([5], d, torch.int32)),
          _exact(lambda x, s: np.roll(x.cpu().numpy(), 5, axis=1))),
    Probe("f32_small_dot", SMALL_DOT, small_dot, small_dot_plain,
          lambda d: (_t(_normal(0, (16, 256)), d), _t(_normal(1, (256, 128)), d)),
          _small_dot_judge),
)


def run_probes(device: torch.device | str) -> dict:
    """Run the eight probes on ``device``; {name: (passed, error)}."""
    results = {}
    for p in PROBES:
        args = p.inputs(torch.device(device))
        out = p.fn(*args).cpu().numpy()
        results[p.name] = p.judge(out, args)
    return results
