"""Device time a frame of the kernels that are PyTorch's or its libraries':
the pyramid (ops/convolve.py), the compaction (ops/detect.py), the glue and
merge of pipeline.py, and the copies and clones of utils/jit.py. Every other
kernel is the port's own."""

NAME = "plain_ms.frames"
UNIT = "ms"
LAYER = "plain PyTorch stages (ops/convolve.py, ops/detect.py, pipeline.py)"
SOURCE = "device_trace"


def is_library(name: str) -> bool:
    low = name.lower()
    return ("at::" in name or "cub::" in name or "cutlass" in low or "gemm" in low
            or name.startswith(("sm80_", "sm90_")) or "memcpy" in low or "memset" in low)


def read(reading):
    p = reading.profile
    frames = p.calls.get("extract_sift", 0) if p is not None else 0
    seconds = p.kernel_s(is_library) if frames else 0.0
    return 1e3 * seconds / frames if seconds > 0 else None
