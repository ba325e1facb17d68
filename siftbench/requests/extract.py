"""``extract``: ``extract_sift`` on the next view of the ring; the caller
reads back the point count."""

from siftbench import compare
from siftbench.flows import Flow


class Extract(Flow):
    def request(self, i: int, keep: bool):
        v = i % len(self.views)
        with self.spans("extract_sift"):
            d = self.program.extract(self.views.frames[v])
        with self.spans("readback"):
            n = int(d.num_pts)
        self.log.append({"n": n})
        return {"view": v, "d": d, "overflow": d.overflow} if keep else None

    def judge(self, kept, reference):
        return [{f"extract.{k}": x for k, x in compare.points(
            k_["d"], reference.extract(self.views.frames[k_["view"]])).items()} for k_ in kept]


REQUEST = Extract
