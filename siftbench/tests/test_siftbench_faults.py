"""A run with the timed path broken underneath comes out not correct, and so
does the control (the plain reference in TF32 in the program's place).

Each cell of BENCHMARK.json is driven end to end on the CPU (the harness's
look for a card is skipped) at a small frame size, held to the cell's own
limits: the program as it is must come out correct, then once for each fault
the cell's traffic can have, and for the control, ``correct`` must read
false.
"""

import dataclasses
import json

import pytest
import torch

from siftbench import harness
from siftbench.program import Port, control
from siftbench.registry import HERE, Registry

CPU = torch.device("cpu")
BENCH = harness.load_benchmark()

# The faults a flow can have: half of the points left out, and an answer
# altered where it is produced (a keypoint's descriptor, a match, the RANSAC
# homography, the refinement's numFit).
FAULTS = {
    "extract": ["half_left_out", "descriptor_altered"],
    "track": ["half_left_out", "descriptor_altered", "match_altered"],
    "register": ["half_left_out", "descriptor_altered", "match_altered",
                 "homography_altered", "num_fit_altered"],
}


class Faulty:
    """The program with one fault planted in what it returns."""

    def __init__(self, inner, fault: str):
        self.inner, self.fault = inner, fault

    def extract(self, image):
        d = self.inner.extract(image)
        if self.fault == "half_left_out":
            n = int(d.num_pts) // 2
            keep = torch.arange(d.max_pts) < n
            d = dataclasses.replace(d, num_pts=torch.tensor(n, dtype=torch.int32), **{
                f: torch.where(keep.reshape((-1,) + (1,) * (getattr(d, f).dim() - 1)),
                               getattr(d, f), torch.zeros((), dtype=getattr(d, f).dtype))
                for f in ("xpos", "ypos", "scale", "sharpness", "edgeness", "orientation",
                          "subsampling", "data")})
        elif self.fault == "descriptor_altered":
            data = d.data.clone()
            data[0] = 0.0
            data[0, 0] = 1.0
            d = dataclasses.replace(d, data=data)
        return d

    def match(self, a, b):
        m = self.inner.match(a, b)
        if self.fault == "match_altered":
            score, match = m.score.clone(), m.match.clone()
            score[0] = score[0] + 0.05
            match[0] = (match[0] + 1) % int(b.num_pts)
            m = dataclasses.replace(m, score=score, match=match)
        return m

    def find_homography(self, matched, draw_seed):
        h, n = self.inner.find_homography(matched, draw_seed)
        if self.fault == "homography_altered":
            h = h.clone()
            h[0, 2] += 0.5
        return h, n

    def improve_homography(self, matched, homography):
        h, nfit, err = self.inner.improve_homography(matched, homography)
        if self.fault == "num_fit_altered":
            nfit = nfit + 1
        return h, nfit, err



def small_cell(tmp_path, cell: str):
    """(bench, registry): ``cell`` with its configuration cut to a small
    frame, in a root of its own; the cell's limits stay its own."""
    w = harness.find_cell(BENCH, cell)
    cfg = Registry().config(w["config"])
    cfg = dict(cfg, frame={"height": 120, "width": 160},
               sift=dict(cfg["sift"], num_octaves=3, max_pts=2048),
               find_homography=dict(cfg["find_homography"], num_loops=256))
    (tmp_path / "configs").mkdir(exist_ok=True)
    (tmp_path / "configs" / f"{w['config']}.json").write_text(json.dumps(cfg))
    mix = Registry().traffic(w["traffic"])
    mix = dict(mix, views=dict(mix["views"], count=4), warm_requests=1, check_requests=2)
    if w["traffic"] == "frames" or w["traffic"] == "track":
        mix["views"]["count"] = 6
    (tmp_path / "traffic").mkdir(exist_ok=True)
    (tmp_path / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
    return Registry([tmp_path, HERE]), cfg, mix["request"]


CASES = [(w["name"], f) for w in BENCH["workloads"]
         for f in ["none", "control"] + FAULTS[Registry().traffic(w["traffic"])["request"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_runs_are_not_correct(tmp_path, cell, fault):
    reg, cfg, flow = small_cell(tmp_path, cell)
    if fault == "none":
        prog = None
    elif fault == "control":
        prog = control(cfg, CPU)
    else:
        prog = Faulty(Port(cfg, CPU), fault)
    r = harness.run_cell(cell, 2**31 + 17, 0.2, False, bench=BENCH, registry=reg,
                         device=CPU, program=prog)
    assert r["attempted"] >= 1 and r["failed"] == 0
    failed = {k: v for k, v in r["check"].items() if not v[0] <= v[1]}
    if fault == "none":
        assert r["correct"], failed
    else:
        assert not r["correct"] and failed, r["check"]
