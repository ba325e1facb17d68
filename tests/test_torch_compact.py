"""Plain version of the compaction kernel (K8) against the JAX package's
compaction, bit for bit (the bar ``tests/test_pallas_compact.py`` sets for
the TPU kernel against its twin), and the wrapper's dispatch on CPU
tensors."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cudasift_tpu.ops.detect import compact_mask as jax_compact
from cudasift_tpu.ops.pallas.compact import compact_mask_pallas

from cudasift_tpu_torch.ops.cuda import compact


def check(mask, capacity):
    launches = compact.KERNEL.launches
    idx, count, total = compact.compact_mask(torch.as_tensor(mask), capacity)
    assert compact.KERNEL.launches == launches          # CPU tensors: plain version
    assert idx.dtype == count.dtype == total.dtype == torch.int32
    ref_idx, ref_count, ref_total = jax_compact(jnp.asarray(mask), capacity, with_total=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert int(count) == int(ref_count) == min(int(mask.sum()), capacity)
    assert int(total) == int(ref_total) == int(mask.sum())
    return int(count)


@pytest.mark.parametrize("shape,density,capacity,expect", [
    ((5, 96, 160), 0.001, 1024, "under"),        # undercapacity
    ((5, 96, 160), 0.01, 256, "full"),           # saturation: total > capacity
    ((5, 64, 128), 0.0, 128, "empty"),           # empty mask
    ((5, 200, 334), 0.003, 384, None),           # not a multiple of 4096 entries
    ((5, 30, 40), 0.5, 512, "full"),             # dense, tiny
])
def test_compact_plain_matches_jax(shape, density, capacity, expect):
    rng = np.random.default_rng(61)
    mask = rng.random(shape) < density
    count = check(mask, capacity)
    if expect == "under":
        assert 0 < count < capacity
    elif expect == "full":
        assert count == capacity
    elif expect == "empty":
        assert count == 0


def test_compact_plain_matches_pallas_kernel():
    """One small case against the TPU kernel itself in interpret mode."""
    mask = np.random.default_rng(62).random((5, 24, 40)) < 0.02
    idx, count, _ = compact.compact_mask(torch.as_tensor(mask), 128)
    ref_idx, ref_count = compact_mask_pallas(jnp.asarray(mask), 128, interpret=True)
    assert int(count) == int(ref_count) > 0
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
