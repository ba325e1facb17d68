"""Finds what ``BENCHMARK.json`` names, by name, in files of their own.

Under each root (``siftbench/`` first unless told otherwise):

- ``configs/<config>.json``: a configuration (frame, settings, source);
- ``traffic/<mix>.json``: a traffic mix's parameters, naming its request
  kind under ``"request"``;
- ``requests/<request>.py``: a request kind (``REQUEST``, a ``flows.Flow``:
  what one request calls, keeps and is judged by);
- ``limits/<cell>.json``: the limits of the numbers a cell is judged by;
- ``layers/<metric>.py``: a per-layer metric (NAME, UNIT, LAYER, SOURCE,
  ``read(reading)``);
- ``counts/<kernel>.py``: the operations and bytes a stage needs;
- ``reference/<name>.py``: a plain reference of extraction, named by a
  configuration's ``"reference"`` (default ``sift``): ``SiftConfig.from_dict``
  and ``extract(image, cfg, precision)``.

Adding any of them is adding a file: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, roots=(HERE,)):
        self.roots = [Path(r) for r in roots]
        self._modules: dict = {}

    def path(self, kind: str, name: str, ext: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise KeyError(f"no {kind}/{name}{ext} under {[str(r) for r in self.roots]}")

    def names(self, kind: str, ext: str) -> list[str]:
        found = set()
        for root in self.roots:
            d = root / kind
            if d.is_dir():
                found.update(p.name[:-len(ext)] for p in d.iterdir()
                             if p.name.endswith(ext) and not p.name.startswith("_"))
        return sorted(found)

    def _json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def module(self, kind: str, name: str):
        """The module in ``<kind>/<name>.py``, loaded from its path (a
        metric's name may hold dots)."""
        key = (kind, name)
        if key not in self._modules:
            p = self.path(kind, name, ".py")
            spec = importlib.util.spec_from_file_location(
                f"siftbench_{kind}_{name}".replace(".", "_").replace("-", "_"), p)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def request(self, name: str):
        return self.module("requests", name).REQUEST

    def reference(self, name: str):
        """The extraction reference ``reference/<name>.py``. One under
        ``siftbench/reference/`` is the package's own module, so its relative
        imports hold; one in another root loads from its path and imports
        absolutely (``from siftbench.reference import sift``)."""
        p = self.path("reference", name, ".py")
        if p.resolve().parent == HERE / "reference":
            return importlib.import_module(f"{__package__}.reference.{name}")
        return self.module("reference", name)

    def layer(self, name: str):
        return self.module("layers", name)

    def count(self, name: str):
        return self.module("counts", name)
