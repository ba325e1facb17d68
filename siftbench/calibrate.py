"""Readings that a cell's limits are set from, in one process.

    python3 siftbench/calibrate.py --workload <cell> --seeds <a,b,...> \
        [--control-seeds <c,d,...>] [--drop-one-seeds <e,f,...>] [--seconds 3]

Runs the cell's window briefly on each program seed, then with the control
(the plain reference in TF32, ``program.control``) in the program's place on
each control seed, and prints every compared number of every run, then per
number the largest program reading (the lower one), the smallest control
reading (the upper one) and the limit the cell's limits file sets. The
benchmark's own runs never run the control. Writes the readings to
``chiprun_out/calibrate-<cell>.json``.

``--drop-one-seeds`` runs the program with one keypoint taken out of the
middle of every point set it extracts (``DropOne``): what a sound run looks
like where the program's orientation kernel finds one peak fewer than the
reference, as it does on some frames. Those readings show how far the
numbers of the reference's own chain move on such a run; they are printed
apart and set neither reading.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class DropOne:
    """The program with the keypoint at a seeded row taken out of each point
    set it extracts; the rows after it move up by one."""

    def __init__(self, inner, seed: int):
        import numpy as np

        self.inner = inner
        self.rng = np.random.default_rng(seed)

    def extract(self, image):
        import dataclasses

        import torch

        d = self.inner.extract(image)
        n = int(d.num_pts)
        k = int(self.rng.integers(0, n))
        rows = {f.name: getattr(d, f.name) for f in dataclasses.fields(d)
                if getattr(d, f.name).dim() >= 1 and getattr(d, f.name).shape[0] == d.max_pts}
        moved = {name: torch.cat([x[:k], x[k + 1:], x[-1:]]) for name, x in rows.items()}
        return dataclasses.replace(d, num_pts=d.num_pts - 1, **moved)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--drop-one-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from siftbench import harness, program
    from siftbench.registry import Registry

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = harness.load_benchmark(ROOT)
    registry = Registry()
    cell = harness.find_cell(bench, args.workload)
    cfg = registry.config(cell["config"])
    limits = registry.limits(args.workload)["check"]
    dev = torch.device("cuda")
    runs = []
    plan = [("program", int(s)) for s in args.seeds.split(",") if s]
    plan += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    plan += [("drop-one", int(s)) for s in args.drop_one_seeds.split(",") if s]
    for side, seed in plan:
        t = time.perf_counter()
        prog = (program.control(cfg, dev, registry) if side == "control"
                else DropOne(program.Port(cfg, dev), seed) if side == "drop-one" else None)
        r = harness.run_cell(args.workload, seed, args.seconds, False, bench=bench,
                             registry=registry, device=dev, program=prog)
        row = {"side": side, "seed": seed, "correct": r["correct"], "attempted": r["attempted"],
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "numbers": r["numbers"], "seconds": time.perf_counter() - t}
        runs.append(row)
        print("calibrate run:", json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    names = sorted({k for r in runs for k in r["numbers"]})
    table = {}
    for n in names:
        prog_v = [r["numbers"].get(n, math.inf) for r in runs if r["side"] == "program"]
        ctrl_v = [r["numbers"].get(n, math.inf) for r in runs if r["side"] == "control"]
        drop_v = [r["numbers"].get(n, math.inf) for r in runs if r["side"] == "drop-one"]
        table[n] = {"lower": max(prog_v) if prog_v else None,
                    "upper": min(ctrl_v) if ctrl_v else None,
                    "limit": limits.get(n), "drop_one": max(drop_v) if drop_v else None}
        print(f"calibrate {n}: lower {table[n]['lower']!r} upper {table[n]['upper']!r} "
              f"limit {table[n]['limit']!r} drop-one {table[n]['drop_one']!r}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"calibrate-{args.workload}.json").write_text(
        json.dumps({"runs": runs, "table": table}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
