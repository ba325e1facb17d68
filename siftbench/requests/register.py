"""``register``: the demo flow (mainSift.cpp:58-78) on the next pair of the
ring: extract A, extract B, ``match_sift_data``, ``find_homography`` with
draws seeded for the request, ``improve_homography``; the caller reads back
the refined homography and numFit.

Judged twice: step by step (each stage of the reference from the program's
inputs to that stage: points from the frames, matches from the program's
points, RANSAC from the program's matches and the same draws, the refinement
from the program's RANSAC homography), and end to end (the reference's own
chain from the frames and the same draws: its matches over the keypoints
paired in view A, its refined homography and numFit)."""

import numpy as np
import torch

from siftbench import compare
from siftbench.flows import Flow
from siftbench.views import derive


class Register(Flow):
    unit = "pair"

    def request(self, i: int, keep: bool):
        p = i % (len(self.views) // 2)
        draw_seed = derive(self.seed, "draws", i)
        prog = self.program
        with self.spans("extract_sift"):
            da = prog.extract(self.views.frames[2 * p])
        with self.spans("extract_sift"):
            db = prog.extract(self.views.frames[2 * p + 1])
        with self.spans("match_sift_data"):
            m = prog.match(da, db)
        with self.spans("find_homography"):
            h1, nm = prog.find_homography(m, draw_seed)
        with self.spans("improve_homography"):
            h2, nfit, err = prog.improve_homography(m, h1)
        with self.spans("readback"):
            h_host = h2.cpu()
            nf = int(nfit)
        self.log.append({"pair": p, "num_fit": nf, "h": h_host.numpy()})
        if not keep:
            return None
        return {"pair": p, "draw_seed": draw_seed, "db": db, "m": m, "ransac": (h1, nm),
                "irls": (h2, nfit, err), "overflow": torch.maximum(da.overflow, db.overflow)}

    def judge(self, kept, reference):
        thresh = float(self.cfg["improve_homography"]["thresh"])
        out = []
        for k in kept:
            p, m = k["pair"], k["m"]
            r = {}
            refs, pairs_a = [], []
            for side, d in (("a", m), ("b", k["db"])):
                ref_d = reference.extract(self.views.frames[2 * p + (side == "b")])
                refs.append(ref_d)
                got = compare.points(d, ref_d, pairs_a if side == "a" else None)
                for n, x in got.items():
                    r[f"extract.{n}"] = max(r.get(f"extract.{n}", 0.0), x)
            r.update({f"match.{n}": x for n, x in compare.matches(
                m, reference.match(m, k["db"])).items()})
            ref_ransac = reference.find_homography(m, k["draw_seed"])
            r.update({f"ransac.{n}": x for n, x in compare.ransac(
                k["ransac"], ref_ransac, self.h, self.w).items()})
            ref_irls = reference.improve_homography(m, k["ransac"][0])
            r.update({f"irls.{n}": x for n, x in compare.refinement(
                k["irls"], ref_irls, int(m.num_pts), thresh, self.h, self.w).items()})
            # The reference's own chain, from its own points.
            ref_m = reference.match(refs[0], refs[1])
            r.update({f"chain.match.{n}": x for n, x in compare.chain_matches(
                m, ref_m, pairs_a).items()})
            ref_h1, _ = reference.find_homography(ref_m, k["draw_seed"])
            ref_chain = reference.improve_homography(ref_m, ref_h1)
            r.update({f"chain.irls.{n}": x for n, x in compare.chain_homography(
                k["irls"], ref_chain, self.h, self.w).items()})
            out.append(r)
        return out

    def summary(self, kept):
        fits = [r["num_fit"] for r in self.log]
        errs = [compare.corner_gap(r["h"], self.views.truths[r["pair"]], self.h, self.w)
                for r in self.log]
        return {"num_fit_min": min(fits, default=None),
                "num_fit_median": float(np.median(fits)) if fits else None,
                "corner_error_px_median": float(np.median(errs)) if errs else None,
                "corner_error_px_max": max(errs, default=None),
                "overflow_max": max((int(k["overflow"]) for k in kept), default=None)}


REQUEST = Register
