"""``track``: ``extract_sift`` on view t, then ``match_sift_data`` of view t
against view t-1's points, kept from the previous request; the caller reads
back the point count.

Judged twice: step by step (the reference's points of view t against the
program's, and the reference's matches of the program's two point sets
against the program's matches), and end to end (the matches that the
reference works out from its own points of both views, against the
program's, over the keypoints paired in view t)."""

from siftbench import compare
from siftbench.flows import Flow


class Track(Flow):
    def warm(self) -> None:
        first = -int(self.traffic["warm_requests"]) - 1
        self.prev_view = first % len(self.views)
        self.prev = self.program.extract(self.views.frames[self.prev_view])
        self.prev_n = int(self.prev.num_pts)
        super().warm()

    def request(self, i: int, keep: bool):
        t = i % len(self.views)
        with self.spans("extract_sift"):
            d = self.program.extract(self.views.frames[t])
        with self.spans("match_sift_data"):
            m = self.program.match(d, self.prev)
        with self.spans("readback"):
            n = int(m.num_pts)
        self.log.append({"n": n, "n_prev": self.prev_n})
        out = ({"view": t, "prev_view": self.prev_view, "m": m, "prev": self.prev,
                "overflow": d.overflow} if keep else None)
        self.prev, self.prev_n, self.prev_view = d, n, t
        return out

    def judge(self, kept, reference):
        out = []
        for k in kept:
            ref_t = reference.extract(self.views.frames[k["view"]])
            pairs: list = []
            r = {f"extract.{n}": x for n, x in compare.points(k["m"], ref_t, pairs).items()}
            r.update({f"match.{n}": x for n, x in compare.matches(
                k["m"], reference.match(k["m"], k["prev"])).items()})
            ref_prev = reference.extract(self.views.frames[k["prev_view"]])
            r.update({f"chain.match.{n}": x for n, x in compare.chain_matches(
                k["m"], reference.match(ref_t, ref_prev), pairs).items()})
            out.append(r)
        return out


REQUEST = Track
