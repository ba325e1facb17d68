"""cudasift_tpu_torch -- the SIFT framework in PyTorch with hand-written
CUDA kernels for Hopper (sm_90a).

The port of ``cudasift_tpu`` (JAX/Pallas for the TPU), module for module.
The same public API takes and returns torch tensors; ``SiftData`` is a
dataclass of tensors. Every Pallas kernel of the main path is a CUDA C++
kernel here (``csrc/``), launched on CUDA tensors; CPU tensors run each
kernel's plain PyTorch version. The package never imports jax.

==========================  =====================================
CudaSift (cudaSift.h)       cudasift_tpu_torch
==========================  =====================================
InitCuda                    device_info
InitSiftData                init_sift_data
ExtractSift                 extract_sift
PrintSiftData               print_sift_data
MatchSiftData               match_sift_data
FindHomography              find_homography
ImproveHomography           improve_homography
==========================  =====================================
"""

import torch

# Float32 stays float32 on the card: no TF32 in matrix products or
# convolutions (PyTorch enables it for cuDNN convolutions by default).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def device_info(dev_num: int = 0) -> None:
    """Print the selected CUDA device, the analogue of InitCuda's banner
    (cudaSiftH.cu:19-37). Raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    count = torch.cuda.device_count()
    dev = min(dev_num, count - 1)
    props = torch.cuda.get_device_properties(dev)
    print(f"Device Number: {dev}")
    print(f"  Device name: {props.name}")
    print(f"  Compute capability: {props.major}.{props.minor}")
    print(f"  Memory: {props.total_memory / 2**30:.1f} GiB")
    print(f"  Total devices: {count}")


from .config import SiftParams, MatchParams, HomographyParams  # noqa: E402
from .sift_data import (SiftData, init_sift_data, print_sift_data,  # noqa: E402
                        ref_style_num_pts)
from .pipeline import extract_sift, extract_sift_throughput  # noqa: E402
from .ops.match import match_sift_data, match_descriptors  # noqa: E402
from .ops.homography import find_homography, improve_homography  # noqa: E402

__all__ = [
    "device_info",
    "SiftParams",
    "MatchParams",
    "HomographyParams",
    "SiftData",
    "init_sift_data",
    "print_sift_data",
    "ref_style_num_pts",
    "extract_sift",
    "extract_sift_throughput",
    "match_sift_data",
    "match_descriptors",
    "find_homography",
    "improve_homography",
]

__version__ = "0.1.0"
