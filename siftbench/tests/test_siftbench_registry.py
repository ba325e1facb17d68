"""BENCHMARK.json keeps to its contract, and everything it names is found
by name; a cell whose configuration, mix, metric and extraction reference
are new files runs without an edit to any file that is there."""

import json
import re

import pytest
import torch

from siftbench import compare, harness
from siftbench.flows import Flow, Spans
from siftbench.program import Port, Reference
from siftbench.reference import sift as ref_sift
from siftbench.reference.precision import FLOAT32
from siftbench.registry import HERE, Registry
from siftbench.views import Views

CPU = torch.device("cpu")

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["siftbench"] and BENCH["command"][1] == "siftbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 0
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts(cell):
    reg = Registry()
    w = harness.find_cell(BENCH, cell)
    cfg = reg.config(w["config"])
    traffic = reg.traffic(w["traffic"])
    assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
    assert reg.limits(cell)["check"]
    e2e = [m["name"] for m in harness.metrics_of(BENCH, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = harness.metrics_of(BENCH, "per_layer", cell)
    assert layers
    for m in layers:
        mod = reg.layer(m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE) == (
            m["name"], m["unit"], m["layer"], m["source"])
        assert m["moves"] in e2e


def test_every_config_names_its_file():
    reg = Registry()
    for c in BENCH["configs"]:
        assert c["file"] == f"siftbench/configs/{c['name']}.json"
        body = reg.config(c["name"])
        assert body["reduced"] == c["reduced"] == [] and body["source"]
        reg.reference(body.get("reference", "sift")).SiftConfig.from_dict(body["sift"])


def test_names_are_found_as_files():
    reg = Registry()
    assert {"cudasift-1920x1080", "cudasift-1280x960"} <= set(reg.names("configs", ".json"))
    assert {"frames", "pairs", "track"} <= set(reg.names("traffic", ".json"))
    assert {"extract", "register", "track"} <= set(reg.names("requests", ".py"))
    for mix in ("frames", "pairs", "track"):
        assert issubclass(reg.request(reg.traffic(mix)["request"]), Flow)
    assert {m["name"] for m in BENCH["per_layer"]} <= set(reg.names("layers", ".py"))
    assert {"dog", "match", "peaks"} <= set(reg.names("counts", ".py"))
    assert "sift" in reg.names("reference", ".py")
    with pytest.raises(KeyError):
        reg.config("no-such-config")


# A request kind that no cell of BENCHMARK.json has: two views a call
# through another entry point of the measured package, judged frame by frame.
TWIN = '''
import dataclasses

from siftbench import compare
from siftbench.flows import Flow


class Twin(Flow):
    unit = "frame"

    def request(self, i, keep):
        v = (2 * i) % len(self.views)
        with self.spans("extract_sift_throughput"):
            d = self.program.package.extract_sift_throughput(self.views.frames[v:v + 2],
                                                             self.program.params)
        with self.spans("readback"):
            n = d.num_pts.tolist()
        self.log.append({"n": sum(n)})
        if not keep:
            return None
        one = [dataclasses.replace(d, **{f.name: getattr(d, f.name)[k]
                                         for f in dataclasses.fields(d)}) for k in range(2)]
        return {"view": v, "d": one, "overflow": d.overflow.max()}

    def judge(self, kept, reference):
        out = []
        for k in kept:
            for j, d in enumerate(k["d"]):
                out.append({f"extract.{n}": x for n, x in compare.points(
                    d, reference.extract(self.views.frames[k["view"] + j])).items()})
        return out


REQUEST = Twin
'''

# An extraction reference that no configuration of the package names: the
# package's own, wrapped, counting its calls.
PROBE = '''
from siftbench.reference import sift

SiftConfig = sift.SiftConfig
CALLS = [0]


def extract(image, cfg, precision):
    CALLS[0] += 1
    return sift.extract(image, cfg, precision)
'''


def test_a_throwaway_cell_is_found_without_editing_a_file(tmp_path):
    """A new configuration, mix, request kind, limits and per-layer metric,
    and extraction reference, each a new file in another root, run as a cell
    of their own on the CPU."""
    for d in ("configs", "traffic", "requests", "limits", "layers", "reference"):
        (tmp_path / d).mkdir()
    cfg = json.loads((HERE / "configs" / "cudasift-1920x1080.json").read_text())
    cfg.update(name="tiny", frame={"height": 96, "width": 128}, reference="probe")
    cfg["sift"].update(num_octaves=3, max_pts=1024)
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "frames.json").read_text())
    mix.update(name="few", request="twin")
    mix["views"].update(count=4)
    mix.update(warm_requests=1, check_requests=2)
    (tmp_path / "traffic" / "few.json").write_text(json.dumps(mix))
    (tmp_path / "requests" / "twin.py").write_text(TWIN)
    (tmp_path / "reference" / "probe.py").write_text(PROBE)
    (tmp_path / "limits" / "tiny-few.json").write_text(
        json.dumps({"check": {"extract.count_pct": 0.0, "extract.pos_px.max": 0.0}}))
    (tmp_path / "layers" / "requests_done.tiny.py").write_text(
        'NAME = "requests_done.tiny"\nUNIT = "requests"\nLAYER = "harness"\n'
        'SOURCE = "program_counter"\n\n\ndef read(reading):\n    return float(len(reading.log))\n')
    bench = dict(BENCH, workloads=[{"name": "tiny-few", "config": "tiny", "traffic": "few",
                                    "chips": 1, "why": "a throwaway cell"}])
    bench["per_layer"] = [{"name": "requests_done.tiny", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "harness",
                           "moves": "frames_per_s", "workloads": ["tiny-few"]}]
    bench["end_to_end"] = [dict(m, workloads=["tiny-few"]) if "workloads" in m else m
                           for m in BENCH["end_to_end"] if m["name"] in
                           ("frames_per_s", "frame_ms_p95", "setup_s")]
    reg = Registry([tmp_path, HERE])
    before = {p: p.read_bytes() for p in HERE.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    plain = harness.run_cell("tiny-few", 2**31 + 1, 0.3, False, bench=bench, registry=reg,
                             device=torch.device("cpu"))
    traced = harness.run_cell("tiny-few", 2**31 + 1, 0.3, True, bench=bench, registry=reg,
                              device=torch.device("cpu"))
    assert plain["correct"] and traced["correct"]
    assert plain["numbers"]["extract.count_pct"] == 0.0 and len(plain["check"]) == 2
    assert set(plain["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert traced["metrics"]["requests_done.tiny"]["value"] == traced["attempted"] > 0
    assert reg.reference("probe").CALLS[0] > 0
    after = {p: p.read_bytes() for p in HERE.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert after == before


def tiny_config(**sift) -> dict:
    cfg = Registry().config("cudasift-1920x1080")
    return dict(cfg, name="tiny", frame={"height": 96, "width": 128},
                sift=dict(cfg["sift"], num_octaves=3, max_pts=1024, **sift))


def test_a_configuration_without_a_reference_takes_the_package_sift():
    """No ``"reference"`` key: the package's ``reference/sift.py`` itself,
    and the same numbers, bit for bit, as calling it directly."""
    cfg = tiny_config()
    assert "reference" not in cfg
    reg = Registry()
    ref = Reference(cfg, CPU, registry=reg)
    assert reg.reference("sift") is ref_sift and ref.extraction is ref_sift

    class Direct(Reference):
        def extract(self, image):
            return ref_sift.extract(image, ref_sift.SiftConfig.from_dict(cfg["sift"]), FLOAT32)

    traffic = reg.traffic("frames")
    views = Views(dict(traffic["views"], count=4), 96, 128, 2**31 + 5, CPU)
    flow = reg.request(traffic["request"])(cfg, traffic, views, Port(cfg, CPU),
                                           Spans(False, CPU), 2**31 + 5)
    kept = [flow.request(i, keep=True) for i in range(2)]
    got = compare.worst(flow.judge(kept, ref))
    assert got and got == compare.worst(flow.judge(kept, Direct(cfg, CPU)))


# A request kind that sends nothing to the program and counts its requests.
SPY = '''
from siftbench.flows import Flow

CALLS = []


class Spy(Flow):
    def request(self, i, keep):
        CALLS.append(i)
        return None


REQUEST = Spy
'''


def test_a_setting_the_reference_lacks_stops_the_run_in_set_up(tmp_path):
    """``scale_up`` with the default reference: ``NotImplementedError`` from
    ``run_cell`` before any request; the same cell without it sends some."""
    for d in ("configs", "traffic", "requests", "limits"):
        (tmp_path / d).mkdir()
    for name, up in (("up", True), ("flat", False)):
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(
            dict(tiny_config(scale_up=up), name=name)))
        (tmp_path / "limits" / f"{name}-spied.json").write_text(
            json.dumps({"check": {"extract.count_pct": 0.0}}))
    mix = json.loads((HERE / "traffic" / "frames.json").read_text())
    mix.update(name="spied", request="spy", warm_requests=1)
    mix["views"].update(count=4)
    (tmp_path / "traffic" / "spied.json").write_text(json.dumps(mix))
    (tmp_path / "requests" / "spy.py").write_text(SPY)
    bench = dict(BENCH, workloads=[
        {"name": f"{c}-spied", "config": c, "traffic": "spied", "chips": 1, "why": "a spy"}
        for c in ("up", "flat")])
    reg = Registry([tmp_path, HERE])
    calls = reg.module("requests", "spy").CALLS
    with pytest.raises(NotImplementedError, match="scale_up"):
        harness.run_cell("up-spied", 2**31 + 7, 5.0, False, bench=bench, registry=reg,
                         device=CPU)
    assert calls == []
    harness.run_cell("flat-spied", 2**31 + 7, 0.05, False, bench=bench, registry=reg,
                     device=CPU)
    assert calls[0] == -1 and len(calls) > 1


def test_an_unknown_reference_is_a_key_error():
    with pytest.raises(KeyError, match=r"reference/no-such\.py"):
        Registry().reference("no-such")
    with pytest.raises(KeyError, match=r"reference/no-such\.py"):
        Reference(dict(tiny_config(), reference="no-such"), CPU)
