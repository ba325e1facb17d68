"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference does not load the measured package; names compare whole."""

import sys

from siftbench import imports


def test_no_file_imports_what_it_may_not():
    assert imports.violations() == []


def test_top_level_names_compare_whole(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "ok.py").write_text("import cudasift_tpu_torch.pipeline\nimport jaxtyping\n")
    (tmp_path / "bad.py").write_text("from jax import numpy\n")
    (tmp_path / "also_bad.py").write_text("import cudasift_tpu.ops\n")
    (tmp_path / "reference" / "leak.py").write_text("from cudasift_tpu_torch import ops\n")
    (tmp_path / "reference" / "fine.py").write_text("from . import sift\nimport torch\n")
    found = imports.violations(tmp_path)
    assert found == ["also_bad.py: ['cudasift_tpu']", "bad.py: ['jax']",
                     "reference/leak.py: ['cudasift_tpu_torch']"]


def test_a_reference_in_another_root_may_not_import_the_port(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "probe.py").write_text(
        "from siftbench.reference import sift\nimport cudasift_tpu_torch.ops\n")
    assert imports.violations(tmp_path) == ["reference/probe.py: ['cudasift_tpu_torch']"]


def test_loaded_modules_are_checked_by_top_level_name():
    assert imports.loaded_forbidden({"cudasift_tpu_torch": 1, "cudasift_tpu_torch.ops": 1,
                                     "jaxtyping": 1}) == set()
    assert imports.loaded_forbidden({"jax._src": 1, "flax": 1, "cudasift_tpu.ops": 1}) == {
        "jax", "flax", "cudasift_tpu"}
    assert imports.loaded_forbidden() == set(), sorted(
        k for k in sys.modules if k.split(".")[0] in imports.FORBIDDEN)
