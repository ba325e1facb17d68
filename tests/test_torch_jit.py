"""``utils.jit`` without a card: CPU tensors run the body, cache keys and
their bound, ``clear_cache``, the eager context manager, and the launch
counters' bookkeeping at capture and replay with ``torch.cuda.CUDAGraph``
replaced by a stand-in; then ``extract_sift_throughput`` on the CPU against
the JAX package's."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import cudasift_tpu as cs

import cudasift_tpu_torch as ct
from cudasift_tpu_torch import pipeline
from cudasift_tpu_torch.utils import jit
from cudasift_tpu_torch.utils.build import Kernel, add_launches, launch_counts
from cudasift_tpu_torch.utils.synth import make_test_image


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's CPU work. The suite runs files in
    parallel worker processes; a worker spinning a full OpenMP pool beside
    the others slows every worker many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass
class Pair:
    total: torch.Tensor
    parts: tuple


def test_cpu_tensors_run_the_body():
    calls = []

    @jit.cuda_graph_jit
    def body(x, k):
        """Doc of the body."""
        calls.append(k)
        return Pair(total=x.sum() * k, parts=(x + k, {"twice": 2 * x}))

    x = torch.arange(4.0)
    out = body(x, 3)
    assert calls == [3] and float(out.total) == 18.0 and not body.programs
    assert torch.equal(out.parts[1]["twice"], 2 * x)
    assert body.__doc__ == "Doc of the body." and body.__name__ == "body"
    body.clear_cache()
    # The pipeline's entry points on the CPU: the body, no program.
    img = make_test_image(48, 64, seed=90)
    ct.extract_sift(img, ct.SiftParams(num_octaves=2), device="cpu")
    ct.extract_sift_throughput(img[None], ct.SiftParams(num_octaves=2), device="cpu")
    assert not pipeline._extract_sift_jit.programs and not pipeline._extract_batch_jit.programs
    assert isinstance(pipeline._extract_sift_jit, jit.GraphJit)
    assert jit.MAX_PROGRAMS == 8


def test_map_tensors_keeps_the_structure():
    d = ct.init_sift_data(8, device="cpu")
    doubled = jit.map_tensors(lambda t: t * 2, (d, [d.xpos + 1, "text"], {"n": 5, "t": d.match}))
    assert isinstance(doubled[0], ct.SiftData) and doubled[0].data.shape == (8, 128)
    assert doubled[1][1] == "text" and doubled[2]["n"] == 5
    assert torch.equal(doubled[1][0], torch.full((8,), 2.0))
    assert torch.equal(doubled[2]["t"], torch.full((8,), -2, dtype=torch.int32))
    cloned = jit.map_tensors(torch.clone, d)
    assert cloned.xpos.data_ptr() != d.xpos.data_ptr() and torch.equal(cloned.match, d.match)


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs nothing (the
    outputs keep what the capture left), and is counted."""

    made = []

    def __init__(self):
        self.replays = 0
        FakeGraph.made.append(self)

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors taken for tensors of ``cuda:0``, with the graph, capture
    context, stream, event and device guard replaced; records what was
    entered and what each program's event was asked."""
    events = []

    class FakeEvent:
        def record(self):
            events.append(("record", self))

        def wait(self):
            events.append(("wait", self))

        def synchronize(self):
            events.append(("synchronize", self))

    @contextlib.contextmanager
    def fake_capture(graph, stream=None):
        events.append(("capture", stream))
        yield
        events.append(("captured", None))

    @contextlib.contextmanager
    def fake_guard(device):
        events.append(("guard", device))
        yield

    dev = torch.device("cuda", 0)
    FakeGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "device", fake_guard)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: ("side stream", device))
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(jit, "_graph_device", lambda args: dev if jit.tensors(args) else None)
    return dev, events


def test_capture_and_replay_keep_the_launch_counts_true(fake_card):
    dev, events = fake_card
    k_a = Kernel("dog.cu", "dog_and_mask", [], name="fake_a")
    k_b = Kernel("refine.cu", "refine_candidates", [], name="fake_b")
    k_idle = Kernel("orient.cu", "orientation_peaks", [], name="fake_idle")
    assert all(k in launch_counts() for k in (k_a, k_b, k_idle))
    bodies = []

    @jit.cuda_graph_jit
    def body(x, scale):
        bodies.append(x)
        k_a.launches += 1                 # what a wrapper does where it launches
        k_b.launches += 3
        return {"y": x * scale}

    x1 = torch.arange(6.0)
    first = body(x1, 2.0)
    # Eager once with the caller's tensor, then captured on static copies: the
    # capture's own counts are taken off, so the call counts one run.
    assert len(bodies) == 2 and bodies[0] is x1 and bodies[1] is not x1
    assert (k_a.launches, k_b.launches, k_idle.launches) == (1, 3, 0)
    assert torch.equal(first["y"], x1 * 2.0)
    assert [e[0] for e in events] == ["guard", "capture", "captured", "guard", "record"]
    assert events[0][1] == dev and events[1][1] == ("side stream", dev)
    (program,) = body.programs.values()
    assert events[-1][1] is program.done
    assert program.launches == {k_a: 1, k_b: 3} and FakeGraph.made[0].replays == 0

    # A replay: inputs copied into the static buffers, outputs cloned, the
    # recorded launches added; the body does not run.
    x2 = torch.arange(6.0) + 10
    del events[:]
    again = body(x2, 2.0)
    assert len(bodies) == 2 and FakeGraph.made[0].replays == 1
    # The call waits for the program's last use before it touches the
    # buffers, and marks its own end behind the clones: calls from two
    # streams are ordered on the device.
    assert events == [("guard", dev), ("wait", program.done), ("record", program.done)]
    assert torch.equal(program.static[0], x2) and program.static[0] is not x2
    assert (k_a.launches, k_b.launches, k_idle.launches) == (2, 6, 0)
    assert again["y"].data_ptr() != program.outputs["y"].data_ptr()
    held = again["y"].clone()
    program.outputs["y"].fill_(-1.0)      # the next replay overwrites the pool
    assert torch.equal(again["y"], held)
    for k in (k_a, k_b):
        k.launches = 0
    body(x1, 2.0)
    body(x1, 2.0)
    assert (k_a.launches, k_b.launches) == (2, 6)          # as two eager runs would count

    # Eager inside the context manager, whatever is cached; programs stay.
    with jit.disable_graphs():
        with jit.disable_graphs():
            body(x1, 2.0)
        eager = body(x2, 2.0)
    assert len(bodies) == 4 and bodies[-1] is x2 and torch.equal(eager["y"], x2 * 2.0)
    assert (k_a.launches, k_b.launches) == (4, 12) and len(body.programs) == 1
    body(x1, 2.0)
    assert len(bodies) == 4 and FakeGraph.made[0].replays == 4
    add_launches({k_a: -k_a.launches})
    assert k_a.launches == 0
    for k in (k_a, k_b, k_idle):
        Kernel.instances.remove(k)


def test_cache_keys_bound_and_clear(fake_card, monkeypatch):
    dev, events = fake_card
    runs = []
    monkeypatch.setattr(jit, "MAX_PROGRAMS", 3)

    @jit.cuda_graph_jit
    def body(x, params):
        runs.append((tuple(x.shape), params))
        return x + 1

    p1, p2 = ct.SiftParams(num_octaves=2), ct.SiftParams(num_octaves=3)
    a, b = torch.zeros((4, 6)), torch.zeros((4, 7))
    body(a, p1)
    body(a, ct.SiftParams(num_octaves=2))       # an equal static: the same program
    assert len(body.programs) == 1 and len(runs) == 2      # eager + capture, then a replay
    body(b, p1)                                 # another shape
    body(a, p2)                                 # another static
    oldest = body.programs[body.key((a, p1), dev)]
    assert not [e for e in events if e[0] == "synchronize"]
    body(a.to(torch.float64), p1)               # another dtype: the oldest (a, p1) goes,
    assert [e for e in events if e[0] == "synchronize"] == [("synchronize", oldest.done)]
    keys = list(body.programs)                  # after its last call has ended
    assert len(keys) == 3 and all(k[0] == dev.index for k in keys)
    assert body.key((a, p1), dev) not in body.programs
    assert body.key((b, p1), dev) == (0, ((4, 7), torch.float32), p1) and keys[0] == body.key((b, p1), dev)
    body(b, p1)                                 # used again: now the newest
    body(a, p1)                                 # captured again; (a, p2) was the oldest
    assert body.key((a, p2), dev) not in body.programs and body.key((b, p1), dev) in body.programs
    kept = {p.done for p in body.programs.values()}
    del events[:]
    body.clear_cache()
    assert not body.programs
    assert {e[1] for e in events if e[0] == "synchronize"} == kept and len(events) == 3
    # A capture that fails raises and leaves no program behind.
    state = {"fail": False}

    @jit.cuda_graph_jit
    def fragile(x):
        if state["fail"]:
            raise RuntimeError("operation not permitted when stream is capturing")
        state["fail"] = True
        return x

    with pytest.raises(RuntimeError, match="capturing"):
        fragile(a)
    assert not fragile.programs
    # While an outer capture is under way a wrapped function runs its body.
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    n = len(runs)
    body(a, p1)
    assert len(runs) == n + 1 and not body.programs
    # Unhashable statics cannot key a program.
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with pytest.raises(TypeError):
        body(a, [1, 2])


def test_tensors_on_two_devices_raise():
    with pytest.raises(ValueError, match="different devices"):
        jit._graph_device((torch.zeros(2), torch.zeros(2, device="meta")))
    assert jit._graph_device((torch.zeros(2), 3, "x")) is None
    assert jit._graph_device((1, 2)) is None
    # Tensors nested in a SiftData or a tuple count too.
    d = ct.init_sift_data(4, device="cpu")
    with pytest.raises(ValueError, match="different devices"):
        jit._graph_device((dataclasses.replace(d, score=torch.zeros(4, device="meta")),))
    with pytest.raises(ValueError, match="different devices"):
        jit._graph_device((d, (3, [torch.zeros(1, device="meta")])))
    assert jit._graph_device((d, ct.SiftParams())) is None


def test_nested_tensors_are_flattened_copied_in_and_keyed(fake_card):
    """A SiftData and a tuple of tensors as arguments: every tensor in them
    is copied into the program's static buffers at a replay, and the key
    holds their structure with the tensors' shapes; statics stay as they
    are."""
    dev, _ = fake_card
    runs = []

    @jit.cuda_graph_jit
    def body(data, pair, k):
        runs.append(data)
        return data.xpos * k + pair[0], pair[1][0].sum()

    d1 = ct.init_sift_data(8, device="cpu")
    d1.xpos += 1.0
    pair = (torch.arange(8.0), [torch.ones(3)])
    first = body(d1, pair, 2.0)
    assert len(runs) == 2 and runs[1] is not d1 and runs[1].xpos is not d1.xpos
    (program,) = body.programs.values()
    assert isinstance(program.static[0], ct.SiftData)
    assert torch.equal(program.static[0].xpos, d1.xpos)
    assert torch.equal(first[0], torch.full((8,), 2.0) + torch.arange(8.0))
    key = body.key((d1, pair, 2.0), dev)
    assert key[0] == dev.index and key[3] == 2.0 and key[1][0] is ct.SiftData
    assert key[1][1][1] == ((8,), torch.float32) and key[1][1][-2] == ((8, 128), torch.float32)
    assert key[2] == (tuple, (((8,), torch.float32), (list, (((3,), torch.float32),))))
    assert len(jit.tensors(d1)) == 16 and jit.tensors(pair)[1] is pair[1][0]
    assert body.key((ct.SiftParams(),), dev) == (0, ct.SiftParams())

    # A replay with other values: every nested tensor is copied in.
    d2 = dataclasses.replace(d1, xpos=torch.full((8,), 5.0),
                             match=torch.zeros(8, dtype=torch.int32))
    pair2 = (torch.zeros(8), [torch.full((3,), 2.0)])
    body(d2, pair2, 2.0)
    assert len(runs) == 2 and len(body.programs) == 1
    for buf, a in zip(jit.tensors(program.static), jit.tensors((d2, pair2, 2.0))):
        assert torch.equal(buf, a) and buf is not a
    # Another capacity, another nested shape or another static: new programs.
    body(ct.init_sift_data(16, device="cpu"), (torch.zeros(16), [torch.ones(3)]), 2.0)
    body(d1, (torch.arange(8.0), [torch.ones(4)]), 2.0)
    body(d1, pair, 3.0)
    assert len(body.programs) == 4 and len(runs) == 8
    body.clear_cache()


def _host_reads(fn, *args):
    """Operations of ``fn(*args)`` that read a tensor on the host or make
    one from host data: under a capture on the card each would raise."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.startswith(("_local_scalar_dense", "lift_fresh")):
                seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    with Watch():
        fn(*args)
    return seen


@pytest.fixture(scope="module")
def matched_pair():
    """Two small dead-leaves frames, extracted and matched on the CPU, and
    their true homography."""
    from cudasift_tpu_torch.utils import synth

    p = ct.SiftParams(num_octaves=2, thresh=2.0, max_pts=1024)
    h_true = synth.known_homography(128, 160)
    frame = synth.make_leaves_image(128, 160, 0)
    da = ct.extract_sift(frame, p, device="cpu")
    db = ct.extract_sift(synth.warp_image(frame, h_true), p, device="cpu")
    return da, db, ct.match_sift_data(da, db), h_true


@pytest.mark.parametrize("program", ["match", "find_homography", "improve_homography"])
def test_program_bodies_read_nothing_on_the_host(program, matched_pair):
    """The calls read no tensor on the host and build none from host data,
    checked on the CPU by the operations they dispatch. Inside a captured
    body either would raise on the card (indexing with the winner's 0-d
    index reads it, an identity from a host list copies it in); outside it
    a copy from host memory waits for the stream (thresholds made with
    ``torch.tensor``). ``match_sift_data`` runs eagerly on the card and reads
    nothing on the host either, so a flow never waits on it."""
    da, db, m, h_true = matched_pair
    calls = {
        "match": (ct.match_sift_data, da, db),
        "find_homography": (ct.find_homography, m, torch.Generator().manual_seed(0), 256,
                            0.0, 0.95, 5.0),
        "improve_homography": (ct.improve_homography, m,
                               torch.as_tensor(h_true, dtype=torch.float32), 5, 0.0, 0.95, 3.0),
    }
    assert _host_reads(*calls[program]) == []


def test_thresholds_are_data_not_keys(fake_card, matched_pair):
    """Two thresholds, one program: ``find_homography`` and
    ``improve_homography`` key their programs by shapes (and IRLS by its
    loop count), and copy the thresholds in at a replay. The programs copy
    in the matched points' fields, not the descriptors."""
    from cudasift_tpu_torch.ops import homography as hom

    _, _, m, h_true = matched_pair
    h = torch.as_tensor(h_true, dtype=torch.float32)
    gen = torch.Generator()
    for fn in (hom._find_homography_jit, hom._improve_homography_jit):
        fn.clear_cache()
    for thresh, max_amb in ((5.0, 0.95), (4.0, 0.8)):
        ct.find_homography(m, gen, num_loops=256, min_score=0.0, max_ambiguity=max_amb,
                           thresh=thresh)
        ct.improve_homography(m, h, 5, 0.0, max_amb, thresh / 2)
    for fn, thresh in ((hom._find_homography_jit, 4.0), (hom._improve_homography_jit, 2.0)):
        (program,) = fn.programs.values()
        assert program.graph.replays == 1
        # The second call's thresholds sit in the static buffers it replayed.
        assert [float(t) for t in jit.tensors(program.static)[-3:]] == [0.0, 0.800000011920929,
                                                                        thresh]
        assert not any(t.shape == m.data.shape for t in jit.tensors(program.static))
    ct.improve_homography(m, h, 4, 0.0, 0.8, 2.0)
    assert len(hom._improve_homography_jit.programs) == 2
    for fn in (hom._find_homography_jit, hom._improve_homography_jit):
        fn.clear_cache()


def keyset(x, y, s, n):
    return {(round(float(a), 2), round(float(b), 2), round(float(c), 2))
            for a, b, c in zip(np.asarray(x)[:n], np.asarray(y)[:n], np.asarray(s)[:n])}


def oriented(x, y, s, o, data, n):
    """Descriptors by rounded (x, y, scale, orientation), as
    tests/test_torch_pipeline.py keys them."""
    f = [np.asarray(v)[:n] for v in (x, y, s, o)]
    keys = zip(*(np.round(v, 2) for v in f[:3]), np.round(f[3], 0))
    return dict(zip(keys, np.asarray(data)[:n]))


def test_throughput_on_the_cpu_matches_jax_throughput():
    """Three frames through ``extract_sift_throughput`` on the CPU against
    the JAX package's (bars as the single-frame test's,
    tests/test_torch_pipeline.py), and against the port's single calls
    exactly."""
    frames = np.stack([make_test_image(128, 160, seed=s) for s in (91, 92, 93)])
    kw = dict(num_octaves=2, thresh=2.0, max_pts=1024)
    jd = cs.extract_sift_throughput(frames, cs.SiftParams(**kw))
    td = ct.extract_sift_throughput(frames, ct.SiftParams(grad_mode="exact", **kw), device="cpu")
    assert td.num_pts.shape == (3,) and td.data.shape == (3, 1024, 128)
    assert td.overflow.shape == (3,) and td.match.dtype == torch.int32
    for i in range(3):
        nj, nt = int(jd.num_pts[i]), int(td.num_pts[i])
        assert nt > 20 and abs(nt - nj) <= max(2, nj // 50), (i, nt, nj)
        one_t = ct.SiftData(**{f: getattr(td, f)[i] for f in ct.SiftData.__dataclass_fields__})
        kj = keyset(*(np.asarray(getattr(jd, f))[i] for f in ("xpos", "ypos", "scale")), nj)
        kt = keyset(one_t.xpos, one_t.ypos, one_t.scale, nt)
        assert len(kj & kt) / max(len(kj), len(kt)) >= 0.97, i
        assert int(one_t.overflow) == int(jd.overflow[i]) == 0
        # Orientation and descriptors of the batched path against the JAX
        # package's batched path, on the oriented keypoints both extract.
        fields = ("xpos", "ypos", "scale", "orientation", "data")
        oj = oriented(*(np.asarray(getattr(jd, f))[i] for f in fields), nj)
        ot = oriented(*(getattr(one_t, f).numpy() for f in fields), nt)
        shared = oj.keys() & ot.keys()
        assert len(shared) >= 0.9 * max(len(oj), len(ot)), (i, len(shared), len(oj), len(ot))
        cos = [float(oj[k] @ ot[k]) for k in shared]
        assert np.median(cos) >= 0.999, (i, np.median(cos))
        single = ct.extract_sift(frames[i], ct.SiftParams(grad_mode="exact", **kw), device="cpu")
        for f in ct.SiftData.__dataclass_fields__:
            assert torch.equal(getattr(one_t, f), getattr(single, f)), (i, f)
        assert not one_t.data[nt:].any()
