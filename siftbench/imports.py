"""What the benchmark may import.

Nothing it runs may load JAX or the JAX package: top-level module names
(the part before the first dot) are compared whole, since the measured
package's name begins with the JAX package's. The reference may not import
the measured package either.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cudasift_tpu"})
MEASURED = "cudasift_tpu_torch"
HERE = Path(__file__).resolve().parent


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules that the benchmark may not load are loaded: {sorted(found)}")
        self.found = found


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> set[str]:
    """The forbidden top-level names among ``sys.modules``' keys."""
    modules = sys.modules if modules is None else modules
    return {top_level(k) for k in list(modules)} & FORBIDDEN


def imported_names(path: Path) -> set[str]:
    """Top-level names of every absolute module that ``path`` imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(top_level(node.module))
    return names


def violations(root: Path = HERE) -> list[str]:
    """Files under ``root`` that import a forbidden name, or, under
    ``reference/``, the measured package."""
    out = []
    for path in sorted(root.rglob("*.py")):
        names = imported_names(path)
        bad = names & FORBIDDEN
        if "reference" in path.relative_to(root).parts:
            bad |= names & {MEASURED}
        if bad:
            out.append(f"{path.relative_to(root)}: {sorted(bad)}")
    return out
