"""Several devices driven from one process: the port's counterpart of
``cudasift_tpu/parallel``."""

from .sharding import (
    Mesh,
    make_mesh,
    extract_sift_batched,
    extract_sift_throughput_sharded,
    match_descriptors_sharded,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "extract_sift_batched",
    "extract_sift_throughput_sharded",
    "match_descriptors_sharded",
]
