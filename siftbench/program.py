"""What a request calls: the system under test through its public entry
points, or the plain reference put in its place (the control).

Both take the settings of a configuration file and expose the same four
calls, so a flow drives either unchanged. A request kind that needs another
entry point of the measured package calls it through ``Port.package``, with
the configuration's settings as ``Port.params``.
"""

from __future__ import annotations

import torch

from .reference import homography as ref_homography
from .reference import match as ref_match
from .reference.precision import FLOAT32, TF32, Precision
from .registry import Registry


class Port:
    """cudasift_tpu_torch, called through ``extract_sift``,
    ``match_sift_data``, ``find_homography`` and ``improve_homography``."""

    name = "cudasift_tpu_torch"

    def __init__(self, cfg: dict, device: torch.device):
        import cudasift_tpu_torch as ct

        self.package = ct
        self.params = ct.SiftParams(**cfg["sift"])
        self.match_params = ct.MatchParams(**cfg.get("match", {}))
        self.find_kw = dict(cfg["find_homography"])
        self.improve_kw = dict(cfg["improve_homography"])
        self.device = device
        self.generator = torch.Generator(device=device)

    def extract(self, image):
        return self.package.extract_sift(image, self.params)

    def match(self, a, b):
        return self.package.match_sift_data(a, b, params=self.match_params)

    def find_homography(self, matched, draw_seed: int):
        self.generator.manual_seed(draw_seed)
        return self.package.find_homography(matched, self.generator, **self.find_kw)

    def improve_homography(self, matched, homography):
        kw = self.improve_kw
        return self.package.improve_homography(matched, homography, kw["num_loops"],
                                               kw["min_score"], kw["max_ambiguity"],
                                               kw["thresh"])


class Reference:
    """The plain reference (``siftbench/reference``) in ``precision``:
    float32 judges, TF32 is the control. Extraction's is the module that the
    configuration names under ``"reference"`` (default ``sift``), found by
    ``registry``; matching's and the homographies' are fixed."""

    def __init__(self, cfg: dict, device: torch.device, precision: Precision = FLOAT32,
                 registry: Registry | None = None):
        self.name = f"reference-{precision}"
        registry = Registry() if registry is None else registry
        self.extraction = registry.reference(cfg.get("reference", "sift"))
        self.sift = self.extraction.SiftConfig.from_dict(cfg["sift"])
        self.find_kw = dict(cfg["find_homography"])
        self.improve_kw = dict(cfg["improve_homography"])
        self.device = device
        self.precision = precision

    def extract(self, image):
        return self.extraction.extract(image, self.sift, self.precision)

    def match(self, a, b):
        return ref_match.match(a, b, self.precision)

    def draws(self, draw_seed: int) -> torch.Tensor:
        """RANSAC's (num_loops, 4) uniform draws, made as the program makes
        them from a generator on the device seeded with ``draw_seed``."""
        g = torch.Generator(device=self.device).manual_seed(draw_seed)
        return torch.rand((int(self.find_kw["num_loops"]), 4), generator=g, device=self.device)

    def find_homography(self, matched, draw_seed: int):
        kw = self.find_kw
        return ref_homography.find_homography(matched, self.draws(draw_seed), kw["min_score"],
                                              kw["max_ambiguity"], kw["thresh"], self.precision)

    def improve_homography(self, matched, homography):
        kw = self.improve_kw
        return ref_homography.improve_homography(matched, homography, kw["num_loops"],
                                                 kw["min_score"], kw["max_ambiguity"],
                                                 kw["thresh"], self.precision)


def control(cfg: dict, device: torch.device, registry: Registry | None = None) -> Reference:
    """The control: the reference at the precision just below float32."""
    return Reference(cfg, device, TF32, registry)
