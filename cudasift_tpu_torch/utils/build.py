"""Build the hand-written CUDA kernels and bind them with ctypes.

Each ``csrc/*.cu`` file exports plain C launchers and is compiled on first
use with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/cudasift_tpu_torch/`` at the repository root. The library's file
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited kernel is rebuilt. Nothing is compiled when a
module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "cudasift_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str, flags: tuple[str, ...]) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared device code
        digest.update(header.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + BASE_FLAGS + flags).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(source: str, flags: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<source>`` into its hashed library unless it exists.
    Returns the library path; raises with nvcc's output on failure."""
    lib = library_path(source, flags)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, *flags, "-o", tmp,
           str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {source} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


class Kernel:
    """One C launcher of a CUDA source, with its launch count.

    ``launches`` rises by one for every successful launch and nowhere else;
    callers may reset it to 0. Calling the object with the CUDA device of
    its tensors and the launcher's arguments builds the library on first
    use, launches under that device's guard on its current stream (the
    capture stream while a CUDA graph is being captured there) and raises if
    the launcher returns a non-zero ``cudaError_t``. ``name`` defaults to
    the source's stem; a source with several launchers names each.
    """

    def __init__(self, source: str, symbol: str, argtypes: list,
                 flags: tuple[str, ...] = (), replaces: str = "", name: str = ""):
        self.name = name or Path(source).stem
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.flags = flags
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    @property
    def source_path(self) -> str:
        return str(Path("cudasift_tpu_torch") / "csrc" / self.source)

    def load(self):
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(build(self.source, self.flags))), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]   # + stream
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        fn = self.load()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} ({self.source}) failed: cudaError_t {err}")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise ValueError unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on the CUDA ``device``."""
    if device.type != "cuda":
        raise ValueError(f"kernels take CPU or CUDA tensors, got {device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def count_tensor(n, name: str, device: torch.device) -> torch.Tensor:
    """A live count for a kernel that reads it on the device: an int becomes
    a 0-d int32 tensor on ``device``; a tensor must already be one."""
    if not isinstance(n, torch.Tensor):
        n = torch.tensor(int(n), dtype=torch.int32, device=device)
    check(n, name, torch.int32, (), device)
    return n
