"""The C++ host codec (``csrc/siftio.cpp``): PGM files and the reference's
SiftPoint records, with numpy codecs when there is no ``g++``.

The extension is compiled with ``g++`` on first use into
``build/cudasift_tpu_torch/`` (the kernels' build directory), its file name
carrying a hash of the source, the flags and the Python it is built for,
and loaded from that path. Where ``g++`` is missing the numpy codecs run
instead, as the JAX package's loader does when its extension is not built;
``have_native()`` says which one runs. A failed build raises. This is host
file I/O, not a device kernel.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile

import numpy as np
import torch

from .build import BUILD_DIR, CSRC

SOURCE = "siftio.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_module = None   # the loaded extension; False once g++ was found missing


def _library_path(include: str) -> str:
    digest = hashlib.sha256()
    digest.update((CSRC / SOURCE).read_bytes())
    digest.update(" ".join(FLAGS + (include, sys.version)).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return str(BUILD_DIR / f"siftio_{digest.hexdigest()[:16]}{suffix}")


def _build() -> str:
    """Compile the extension unless its hashed library exists; return its
    path. Raises with the compiler's output on failure."""
    include = sysconfig.get_paths()["include"]
    lib = _library_path(include)
    if os.path.exists(lib):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *FLAGS, f"-I{include}", str(CSRC / SOURCE), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed on {SOURCE} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def _native():
    """The extension module, built and loaded on first use; None without
    ``g++``."""
    global _module
    if _module is None:
        if shutil.which("g++") is None:
            _module = False
        else:
            name = "cudasift_tpu_torch._siftio"
            loader = importlib.machinery.ExtensionFileLoader(name, _build())
            spec = importlib.util.spec_from_file_location(name, loader.path, loader=loader)
            _module = importlib.util.module_from_spec(spec)
    return _module or None


def have_native() -> bool:
    """True when the C++ codec runs, False when the numpy codecs do."""
    return _native() is not None


def read_pgm_native(path: str) -> np.ndarray:
    """Binary PGM -> float32 (H, W) via the C++ codec (numpy without g++)."""
    native = _native()
    if native is None:
        from .io import read_pgm

        return read_pgm(path)
    raw, h, w = native.pgm_read(path)
    return np.frombuffer(raw, np.float32).reshape(h, w).copy()


def write_pgm_native(path: str, img: np.ndarray) -> None:
    """float32 (H, W) -> binary PGM; the C++ codec rounds to the nearest
    level, the numpy one truncates."""
    native = _native()
    if native is None:
        from .io import write_pgm

        write_pgm(path, img)
        return
    arr = np.ascontiguousarray(img, np.float32)
    native.pgm_write(path, arr.tobytes(), arr.shape[0], arr.shape[1])


_HEADER_FIELDS = (
    "xpos", "ypos", "scale", "sharpness", "edgeness", "orientation",
    "score", "ambiguity", "match", "match_xpos", "match_ypos",
    "match_error", "subsampling",
)


def to_cudasift_records(data) -> bytes:
    """Serialize a SiftData to the reference's 144-float AoS SiftPoint layout
    (cudaSift.h:6-22), byte-compatible with CudaSift memory dumps."""
    n = int(data.num_pts)
    header = np.stack(
        [getattr(data, f)[:n].cpu().numpy().astype(np.float32) for f in _HEADER_FIELDS]
    )
    desc = np.ascontiguousarray(data.data[:n].cpu().numpy(), np.float32)
    native = _native()
    if native is not None:
        return native.pack_siftpoints(header.tobytes(), desc.tobytes(), n)
    rec = np.zeros((n, 144), np.float32)
    rec[:, :8] = header[:8].T
    rec[:, 8:9].view(np.int32)[:, 0] = header[8].astype(np.int32)
    rec[:, 9:13] = header[9:13].T
    rec[:, 16:144] = desc
    return rec.tobytes()


def from_cudasift_records(blob: bytes, max_pts: int | None = None,
                          device: torch.device | str = "cuda"):
    """Parse reference-layout SiftPoint records into a SiftData on
    ``device`` (the card unless the caller asks for the CPU)."""
    from ..sift_data import init_sift_data

    n = len(blob) // (144 * 4)
    native = _native()
    if native is not None:
        hdr_b, desc_b = native.unpack_siftpoints(blob, n)
        header = np.frombuffer(hdr_b, np.float32).reshape(13, n)
        desc = np.frombuffer(desc_b, np.float32).reshape(n, 128)
    else:
        rec = np.frombuffer(blob, np.float32).reshape(n, 144)
        header = np.empty((13, n), np.float32)
        header[:8] = rec[:, :8].T
        header[8] = rec[:, 8:9].view(np.int32)[:, 0].astype(np.float32)
        header[9:13] = rec[:, 9:13].T
        desc = rec[:, 16:144]
    cap = max_pts or max(((n + 127) // 128) * 128, 128)
    data = init_sift_data(cap, device)
    data.num_pts.fill_(n)
    for i, f in enumerate(_HEADER_FIELDS):
        vals = header[i].astype(np.int32 if f == "match" else np.float32)
        getattr(data, f)[:n] = torch.as_tensor(vals)
    data.data[:n] = torch.from_numpy(np.array(desc, np.float32))
    return data
