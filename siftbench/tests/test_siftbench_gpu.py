"""Each cell on the card for a short window: correct, with its end-to-end
metrics, and traced, with its per-layer metrics and a device busy time.
Marked ``gpu``: each test skips without a CUDA device. On the card:
``python -m pytest siftbench/tests -q -m gpu``."""

import pytest
import torch

from siftbench import harness

pytestmark = pytest.mark.gpu
BENCH = harness.load_benchmark()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cuda, cell):
    plain = harness.run_cell(cell, 2**31 + 23, 2.0, False, bench=BENCH, device=cuda)
    assert plain["correct"], plain["check"]
    e2e = {m["name"] for m in harness.metrics_of(BENCH, "end_to_end", cell)}
    assert set(plain["metrics"]) == e2e
    assert plain["device"]["platform"] == "gpu" and plain["device"]["memory_peak_bytes"] > 0
    traced = harness.run_cell(cell, 2**31 + 29, 3.0, True, bench=BENCH, device=cuda)
    assert traced["correct"], traced["check"]
    layers = {m["name"] for m in harness.metrics_of(BENCH, "per_layer", cell)}
    assert set(traced["metrics"]) == layers
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    for name, m in traced["metrics"].items():
        if "roofline" in name:
            assert 0 < m["value"] <= 105
    assert traced["breakdown"]["device_ops"] and len(traced["breakdown"]["idle_gaps"]) <= 10
