"""The repository root on the path, so ``siftbench`` and the measured
package import from any working directory, and torch's CPU threads shared
out among the test workers. Nothing here imports JAX."""

import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
