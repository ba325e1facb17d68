"""``utils.trace`` without a card: off it records nothing and changes no
result; host spans nest under their roots; stages on CPU tensors give each
octave's glue as its time less its children's; tracing state keys a
separate program; and, with ``torch.cuda.CUDAGraph`` replaced by the
stand-in of ``tests/test_torch_jit.py``, the jit spans, the call records
and the captures, replays and evictions counters, with the launch counts as
they are untraced."""

import pytest
import torch

import cudasift_tpu_torch as ct
from cudasift_tpu_torch.utils import jit, trace
from cudasift_tpu_torch.utils.build import Kernel
from cudasift_tpu_torch.utils.synth import make_test_image

from test_torch_jit import FakeGraph, fake_card  # noqa: F401  (the stand-in card)


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and nothing recorded, on
    one intra-op thread (the suite runs files in parallel workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()
    torch.set_num_threads(threads)


PARAMS = ct.SiftParams(num_octaves=2, thresh=2.0, max_pts=512)


def demo_flow():
    """Extraction, matching, RANSAC and IRLS on two small CPU frames."""
    a = ct.extract_sift(make_test_image(64, 96, seed=21), PARAMS, device="cpu")
    b = ct.extract_sift(make_test_image(64, 96, seed=21)[:, ::-1].copy(), PARAMS, device="cpu")
    m = ct.match_sift_data(a, b)
    h, n = ct.find_homography(m, torch.Generator().manual_seed(4), num_loops=64)
    h2, fit, err = ct.improve_homography(m, h, 2)
    return a, b, m, h, n, h2, fit, err


def flat(out):
    return jit.tensors(out)


def test_off_records_nothing_and_on_changes_no_bit():
    off = demo_flow()
    snap = trace.snapshot()
    assert not snap["enabled"] and snap["spans"] == [] and snap["stages"] == {}
    assert snap["calls"] == [] and snap["dropped_spans"] == 0
    trace.enable()
    on = demo_flow()
    assert all(torch.equal(x, y) for x, y in zip(flat(off), flat(on), strict=True))
    snap = trace.snapshot()
    roots = [s["name"] for s in snap["spans"] if s["parent"] == -1]
    assert roots == ["extract_sift", "extract_sift", "match_sift_data", "find_homography",
                     "improve_homography"]
    assert snap["stages"]["extract.pyramid"]["count"] == 2
    assert snap["stages"]["ransac.score"]["count"] == 1
    assert {"ransac.sample", "ransac.refit"} <= set(snap["stages"])
    trace.clear()
    assert trace.snapshot()["spans"] == [] and trace.snapshot()["stages"] == {}


def test_spans_nest_under_their_roots(monkeypatch):
    trace.enable()
    with trace.span("a"):
        with trace.span("b"):
            with trace.span("c"):
                pass
        with trace.span("d"):
            pass
    with trace.span("e"):
        pass
    m = demo_flow()[2]
    ct.find_homography(m, torch.Generator().manual_seed(5), num_loops=32)
    spans = trace.snapshot()["spans"]
    by = {s["name"]: s for s in spans[:5]}
    assert [s["id"] for s in spans] == list(range(len(spans)))
    assert (by["a"]["parent"], by["b"]["parent"], by["c"]["parent"], by["d"]["parent"]) == (
        -1, by["a"]["id"], by["b"]["id"], by["a"]["id"])
    assert {by[k]["root"] for k in "abcd"} == {by["a"]["id"]}
    assert by["e"]["parent"] == -1 and by["e"]["root"] == by["e"]["id"]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] >= 0:
            parent = spans[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
            assert s["root"] == parent["root"]
    # The call's spans share its root's id: the draws are a child of RANSAC.
    draws = [s for s in spans if s["name"] == "ransac.draws"]
    assert len(draws) == 2 and all(spans[d["parent"]]["name"] == "find_homography"
                                   and d["root"] == d["parent"] for d in draws)
    # Spans past the capacity are counted, not kept.
    monkeypatch.setattr(trace, "SPAN_CAPACITY", len(spans) + 1)
    with trace.span("kept"):
        with trace.span("dropped"):
            pass
    snap = trace.snapshot()
    assert snap["spans"][-1]["name"] == "kept" and snap["dropped_spans"] == 1


@pytest.mark.parametrize("use_fused", [True, False])
def test_glue_is_the_octave_less_its_stages(use_fused):
    params = ct.SiftParams(num_octaves=3, thresh=2.0, max_pts=512, use_fused=use_fused)
    trace.enable()
    ct.extract_sift(make_test_image(64, 96, seed=22), params, device="cpu")
    stages = trace.snapshot()["stages"]
    assert stages["extract.pyramid"]["count"] == stages["extract.merge"]["count"] == 1
    children = ("extract.dog", "extract.compact", "extract.refine", "extract.describe")
    assert stages["extract.octave"]["count"] == 3
    assert all(stages[k]["count"] == 3 for k in children[:3])
    # The split path's K6 and K7 are each an interval of the describe stage.
    assert stages["extract.describe"]["count"] == (3 if use_fused else 6)
    octave = stages["extract.octave"]
    assert octave["self_ms"] == pytest.approx(
        octave["ms"] - sum(stages[k]["ms"] for k in children), rel=1e-9, abs=1e-9)
    assert octave["self_ms"] >= 0
    for k in children + ("extract.pyramid", "extract.merge"):
        assert stages[k]["self_ms"] == pytest.approx(stages[k]["ms"]) and stages[k]["ms"] > 0


def test_tracing_state_is_part_of_the_key():
    dev = torch.device("cuda", 0)
    args = (torch.zeros((4, 6)), PARAMS)
    off = jit.GraphJit.key(args, dev)
    assert off == (0, ((4, 6), torch.float32), PARAMS)
    trace.enable()
    on = jit.GraphJit.key(args, dev)
    assert on != off and on[:-1] == off


def test_jit_spans_counters_and_launches_on_the_stand_in(fake_card, monkeypatch):
    dev, events = fake_card
    k = Kernel("dog.cu", "dog_and_mask", [], name="fake_traced")

    @jit.cuda_graph_jit
    def body(x):
        k.launches += 2
        with trace.stage("body.all", x.device):
            return x * 2

    x = torch.arange(6.0)
    body(x)
    body(x)
    untraced = k.launches
    assert (body.captures, body.replays, body.evictions) == (1, 1, 0)
    trace.enable()
    for _ in range(3):
        with trace.span("request"):
            out = body(x + 1)
    assert torch.equal(out, (x + 1) * 2)
    # A second program for the traced key; the launches count as untraced.
    assert len(body.programs) == 2 and k.launches == untraced + 3 * 2
    assert (body.captures, body.replays, body.evictions) == (2, 3, 0)
    snap = trace.snapshot()
    spans = snap["spans"]
    names = [s["name"] for s in spans]
    assert names == ["request", "jit.capture"] + ["request", "jit.copy_in", "jit.replay",
                                                  "jit.clone"] * 2
    requests = [s["id"] for s in spans if s["name"] == "request"]
    assert all(s["root"] in requests and (s["parent"] == s["root"]) == (s["name"] != "request")
               for s in spans)
    # The stand-in's replays: each replayed call's record, read at the next
    # call or the snapshot, under its own request; no gap before the first.
    calls = snap["calls"]
    assert [c["root"] for c in calls] == requests[1:]
    assert calls[0]["gap_ms"] is None and calls[1]["gap_ms"] == 0.0
    assert {c["function"] for c in calls} == {"body"}
    (traced,) = [p for p in snap["programs"] if p["function"] == "body" and p["traced"]]
    assert traced["replays"] == 2 and traced["nodes"] is None
    # The body runs on CPU tensors here: its stage stamps the host clock, at
    # the eager run and at the captures of the traced program's two graphs.
    assert snap["stages"]["body.all"]["count"] == 3
    assert snap["counters"]["by_function"]["body"] == {"captures": 2, "replays": 3,
                                                       "evictions": 0}
    assert snap["launches"]["fake_traced"] == k.launches
    # The traced program's calls take its two graphs in turn.
    assert [g.replays for g in FakeGraph.made] == [1, 1, 1]
    # An evicted program counts, and is read before it goes.
    monkeypatch.setattr(jit, "MAX_PROGRAMS", 1)
    body(torch.arange(3.0))
    assert body.evictions == 2 and len(body.programs) == 1
    assert trace.snapshot()["counters"]["jit.evictions"] >= 2
    body.clear_cache()
    Kernel.instances.remove(k)
