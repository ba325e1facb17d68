"""The port's own tracing: host spans at its layer boundaries, device stages
inside its captured programs, and the counters of those programs.

Tracing is off by default. ``enable()`` turns it on, ``disable()`` off,
``clear()`` drops what was recorded and ``snapshot()`` returns the records
held in memory and the counters as plain data; nothing is written to a file.

Off, a host span or a stage costs one check of a module flag and returns a
shared ``nullcontext``: no allocation, no clock read. A program's stage
markers cost nothing at replay, since the body of a captured program does
not run then, and nothing is captured for them while tracing is off. Whether
tracing is on is part of a program's key (``utils.jit.GraphJit.key``), so
turning it on captures a separate program and the one captured with tracing
off stays node for node what it was.

Host spans (``span(name)``) hold a name, start and end, their own id, their
parent's and their root's: the spans of one call share the root's id. The
clock is ``time.time_ns()``, the one the profiler's timeline uses (kineto
stamps CLOCK_REALTIME nanoseconds), so a span and a device activity of a
``torch.profiler`` session compare directly. Roots are the public entries
(``extract_sift``, ``extract_sift_throughput``, ``match_sift_data``,
``find_homography``, ``improve_homography``); ``utils.jit`` opens
``jit.capture`` (the first call's eager run and its capture),
``jit.copy_in``, ``jit.replay`` (``graph.replay()``, that is
``cudaGraphLaunch``) and ``jit.clone``, and ``find_homography`` opens
``ransac.draws``. Spans are held in lists of ``SPAN_CAPACITY`` allocated
by the first ``enable()``; those past it are counted as dropped.

Device stages (``stage(name, device)``) split a program's body:

- on the card, each boundary launches the stamp kernel (``STAMP``,
  ``csrc/stamp.cu``: one thread writes the device's ``%globaltimer`` into a
  slot of a pinned host buffer), a kernel like the others, counted in its
  ``launches``. While a program is captured with tracing on the stamps
  become kernel nodes of its graph (counted apart, as ``stamp`` nodes), and
  a boundary with no node captured since the last one reuses that one's
  stamp, so adjacent boundaries share a node (an octave's start is its
  ``extract.dog`` start: 33 nodes a 1920x1080 frame). Timing events
  recorded in a graph read back too, but cost about 4.2 us a node against
  about a launch for a stamp (``PERF.md``). Eager on the card, stamps are
  read at ``snapshot()`` (or once more than ``EAGER_PENDING`` runs wait);
- on CPU tensors, the host clock: CPU work is done when it returns.

A stage's self time is its duration less its child stages'. Stages are
totalled by name; ``snapshot()`` also gives each program's last replay in
full.

Each call of a program captured with tracing on records four timing events
on the caller's stream, outside the graph (``jit.call``): before the
copy-in, after it, after the replay and after the clones. They give the
copy-in, the replay and the clones on the device, and the device time from
the program's previous call's end to this call's start.

A program captured with tracing on holds two graphs of its body, each with
its own markers, and its calls replay them in turn (``utils.jit``). Once a
call is on the stream, the program waits on the host for the call before it
and reads that call's stage times and events, while the device runs the new
one: the reads cost no device time, and the other graph is not replayed
again before they are done. So tracing on serialises the replays of one
program: a call returns only once the one before it has finished. A
closed-loop caller has waited for it already.

The counters are always on: per program, its graph's nodes by type, read at
capture (``capture_nodes``); per wrapped function ``captures``, ``replays``
and ``evictions`` (``utils.jit.GraphJit``); per kernel ``launches``
(``utils.build.Kernel``). ``snapshot()`` reads them where they are kept.
Not thread-safe: one host thread at a time, as ``utils.jit``.
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import torch

from .build import Kernel

SPAN_CAPACITY = 1 << 18
EAGER_PENDING = 64
MAX_MARKS = 4096          # stage boundaries a traced run of a body may stamp

# The stage marker: one thread writes %globaltimer into a slot (csrc/stamp.cu).
STAMP = Kernel("stamp.cu", "stamp", [ctypes.c_void_p, ctypes.c_int])

_on = False
_NULL = contextlib.nullcontext()

# cudaGraphNodeType / CUgraphNodeType.
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "event_wait", 7: "event_record", 8: "semaphore_signal",
              9: "semaphore_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
              13: "conditional"}


def enable() -> None:
    """Turn tracing on: programs captured from now on carry stage markers.
    The first call allocates the span lists."""
    global _on
    _T.allocate()
    _on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays until ``clear()``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Timeline:
    """The stages of one run of a body: boundary points and the intervals
    between them, each with its parent. On the host a point is a
    ``time.time_ns()`` stamp; on the card (eager, or captured into a graph)
    it is a slot of ``slots`` that the stamp kernel writes."""

    def __init__(self, kind: str, slots: torch.Tensor | None = None):
        self.kind = kind                  # "host", "card" or "graph"
        self.points: list[int] = []       # host stamps, or slots used
        self.intervals: list[list] = []   # [name, start point, end point, parent]
        self.open: list[int] = []
        self.slots = slots
        self.done = None                  # a card run's end, once it has ended
        self._tail = None

    def _boundary(self) -> int:
        if self.kind == "host":
            self.points.append(time.time_ns())
            return len(self.points) - 1
        stream = torch.cuda.current_stream()
        if self.kind == "graph":
            tail = _capture_tail(stream.cuda_stream)
            if self.points and tail is not None and tail == self._tail:
                return len(self.points) - 1
        n = len(self.points)
        if self.slots is None:
            self.slots = _slots()
        if n == self.slots.numel():
            raise RuntimeError(f"more than {n} stage boundaries in one traced run")
        STAMP(stream.device, ctypes.c_void_p(self.slots.data_ptr()), n)
        self.points.append(n)
        if self.kind == "graph":
            self._tail = _capture_tail(stream.cuda_stream)
        return n

    def enter(self, name: str) -> None:
        parent = self.open[-1] if self.open else -1
        self.open.append(len(self.intervals))
        self.intervals.append([name, self._boundary(), -1, parent])

    def exit(self) -> None:
        self.intervals[self.open.pop()][2] = self._boundary()

    def times_ms(self) -> list[float]:
        """Each point's time from the first, in ms; a card run must be done."""
        stamps = self.points if self.kind == "host" else self.slots[:len(self.points)].tolist()
        return [(t - stamps[0]) / 1e6 for t in stamps]

    def fold(self, times: list[float], totals: dict) -> None:
        """Add each interval's duration and self time to ``totals`` by name."""
        dur = [times[e] - times[s] for _, s, e, _ in self.intervals]
        own = list(dur)
        for i, (_, _, _, parent) in enumerate(self.intervals):
            if parent >= 0:
                own[parent] -= dur[i]
        for i, (name, _, _, _) in enumerate(self.intervals):
            t = totals.get(name)
            if t is None:
                t = totals[name] = [0, 0.0, 0.0]
            t[0] += 1
            t[1] += dur[i]
            t[2] += own[i]

    def as_records(self, times: list[float]) -> list[dict]:
        return [{"name": name, "start_ms": times[s], "end_ms": times[e], "parent": parent}
                for name, s, e, parent in self.intervals]


def _slots() -> torch.Tensor:
    """Stamp slots in pinned host memory, which the card writes through
    unified addressing (plain memory where there is no card: only the
    stand-in of the tests makes a traced program there, and stamps
    nothing)."""
    return torch.zeros(MAX_MARKS, dtype=torch.int64, pin_memory=torch.cuda.is_available())


class _Tracer:
    """What tracing holds in memory."""

    def __init__(self):
        self.names: list = []
        self.start: list[int] = []
        self.end: list[int] = []
        self.parent: list[int] = []
        self.root: list[int] = []
        self.generation = 0
        self.graph: _Timeline | None = None    # the timeline of the capture under way
        self.reset()

    def allocate(self) -> None:
        if not self.names:
            n = SPAN_CAPACITY
            self.names, self.start, self.end = [None] * n, [0] * n, [0] * n
            self.parent, self.root = [-1] * n, [-1] * n

    def reset(self) -> None:
        self.n = 0
        self.dropped = 0
        self.open: list[int] = []
        self.generation += 1
        self.calls: list[tuple] = []
        self.stages: dict[str, list] = {}      # name -> [count, ms, self ms]
        self.host = _Timeline("host")
        self.card = _Timeline("card")
        self.pending: list[_Timeline] = []     # card runs not read yet

    def root_id(self) -> int:
        return self.root[self.open[-1]] if self.open else -1

    def read_pending(self, keep: int = 0) -> None:
        while len(self.pending) > keep:
            tl = self.pending.pop(0)
            tl.done.synchronize()
            tl.fold(tl.times_ms(), self.stages)


_T = _Tracer()


class _Span:
    __slots__ = ("name", "i", "generation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        t = _T
        i = t.n
        self.generation = t.generation
        if i >= SPAN_CAPACITY:
            t.dropped += 1
            self.i = -1
            return self
        t.n = i + 1
        t.names[i] = self.name
        parent = t.open[-1] if t.open else -1
        t.parent[i] = parent
        t.root[i] = t.root[parent] if parent >= 0 else i
        t.end[i] = 0
        t.open.append(i)
        self.i = i
        t.start[i] = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        t = _T
        if self.i >= 0 and self.generation == t.generation:
            t.end[self.i] = end
            t.open.pop()
        return False


def span(name: str):
    """A host span around a layer's call (see the module)."""
    return _Span(name) if _on else _NULL


class _Stage:
    __slots__ = ("timeline", "name")

    def __init__(self, timeline: _Timeline, name: str):
        self.timeline = timeline
        self.name = name

    def __enter__(self):
        self.timeline.enter(self.name)
        return self

    def __exit__(self, *exc):
        tl = self.timeline
        tl.exit()
        if tl.open or tl.kind == "graph":
            return False
        # The outermost host or card stage has ended: its run is complete.
        if tl is _T.host:
            tl.fold(tl.times_ms(), _T.stages)
            _T.host = _Timeline("host")
        elif tl is _T.card:
            tl.done = torch.cuda.Event()
            tl.done.record()
            _T.pending.append(tl)
            _T.card = _Timeline("card")
            _T.read_pending(keep=EAGER_PENDING)
        return False


def stage(name: str, device: torch.device):
    """A device stage of a program's body on ``device`` (see the module)."""
    if not _on:
        return _NULL
    if device.type != "cuda":
        return _Stage(_T.host, name)
    if torch.cuda.is_current_stream_capturing():
        return _Stage(_T.graph, name) if _T.graph is not None else _NULL
    return _Stage(_T.card, name)


class ProgramTrace:
    """A program captured with tracing on: the stage timelines of its two
    graphs, which its calls take in turn, and three sets of its calls' four
    timing events, used in turn (the call being recorded, the one before
    it, whose times are read, and the one before that, whose end starts the
    gap)."""

    def __init__(self, function: str):
        self.function = function
        # Slots made here: no pinned memory may be allocated in a capture.
        self.marks = (_Timeline("graph", _slots()), _Timeline("graph", _slots()))
        self.sets = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
                     for _ in range(3)]
        self.roots = [-1] * 3
        self.generations = [0] * 3
        self.calls = 0                    # calls made
        self.read_upto = 0                # calls read
        self.last: tuple | None = None    # (timeline, point times) of the last replay read
        self.stream = None                # the current call's stream

    def mark(self, i: int) -> None:
        """Record the current call's event ``i`` (0 before the copy-in, 1
        after it, 2 after the replay, 3 after the clones) on its stream."""
        self.sets[self.calls % 3][i].record(self.stream)

    def begin(self, stream: torch.cuda.Stream) -> int:
        """Mark a call's start on ``stream``, the caller's (looked up once a
        call: each lookup costs about as much as recording an event); returns
        which of the two graphs the call replays."""
        k = self.calls % 3
        self.roots[k] = _T.root_id()
        self.generations[k] = _T.generation
        self.stream = stream
        self.mark(0)
        return self.calls % 2

    def end(self) -> None:
        """After the call's last mark, read the call before it: the device
        has finished that one, or finishes it before this one, and its graph
        is not replayed before the next call."""
        self.calls += 1
        self.flush(keep=1)

    def flush(self, keep: int = 0) -> None:
        """Read every call but the last ``keep``: wait for each, and add its
        stages and call record unless ``clear()`` came after it."""
        while self.read_upto < self.calls - keep:
            j = self.read_upto
            self.read_upto += 1
            ev = self.sets[j % 3]
            ev[3].synchronize()
            if self.generations[j % 3] != _T.generation:
                continue
            marks = self.marks[j % 2]
            if marks.points:
                times = marks.times_ms()
                marks.fold(times, _T.stages)
                self.last = (marks, times)
            gap = None
            if j >= 1 and self.generations[(j - 1) % 3] == _T.generation:
                gap = self.sets[(j - 1) % 3][3].elapsed_time(ev[0])
            _T.calls.append((self.roots[j % 3], self.function, ev[0].elapsed_time(ev[1]),
                             ev[1].elapsed_time(ev[2]), ev[2].elapsed_time(ev[3]), gap))


@contextlib.contextmanager
def capturing(marks: _Timeline | None):
    """While a program's body is captured, its stages go to ``marks``, one
    of a ``ProgramTrace``'s timelines (nowhere when None: tracing was off)."""
    before = _T.graph
    _T.graph = marks
    try:
        yield
    finally:
        _T.graph = before


# ---- the graph under capture, through libcuda --------------------------------

_libcuda_lib = None


def _libcuda():
    """``libcuda`` with the four calls below typed, or None without a card."""
    global _libcuda_lib
    if _libcuda_lib is None:
        _libcuda_lib = False
        if torch.cuda.is_available():
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError:
                return None
            p = ctypes.c_void_p
            # The v2 entry point keeps its signature in every libcuda since
            # CUDA 11.3; the v3 one adds the edges' data.
            info = getattr(lib, "cuStreamGetCaptureInfo_v2", None)
            extra = []
            if info is None:
                info = lib.cuStreamGetCaptureInfo_v3
                extra = [ctypes.POINTER(p)]
            info.argtypes = ([p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
                              ctypes.POINTER(p), ctypes.POINTER(ctypes.POINTER(p))] + extra
                             + [ctypes.POINTER(ctypes.c_size_t)])
            info.restype = ctypes.c_int
            lib.capture_info = info
            lib.capture_info_extra = bool(extra)
            lib.cuGraphGetNodes.argtypes = [p, ctypes.POINTER(p), ctypes.POINTER(ctypes.c_size_t)]
            lib.cuGraphGetNodes.restype = ctypes.c_int
            lib.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
            lib.cuGraphNodeGetType.restype = ctypes.c_int
            _libcuda_lib = lib
    return _libcuda_lib or None


def _capture_info(stream: int):
    """(graph under capture, its current tail nodes) of ``stream``, or None."""
    lib = _libcuda()
    if lib is None:
        return None
    status = ctypes.c_int()
    ident = ctypes.c_uint64()
    graph = ctypes.c_void_p()
    deps = ctypes.POINTER(ctypes.c_void_p)()
    n = ctypes.c_size_t()
    extra = [ctypes.byref(ctypes.POINTER(ctypes.c_void_p)())] if lib.capture_info_extra else []
    err = lib.capture_info(ctypes.c_void_p(stream), ctypes.byref(status), ctypes.byref(ident),
                           ctypes.byref(graph), ctypes.byref(deps), *extra, ctypes.byref(n))
    if err != 0 or status.value != 1:       # CU_STREAM_CAPTURE_STATUS_ACTIVE
        return None
    return graph.value, tuple(deps[i] for i in range(n.value))


def _capture_tail(stream: int):
    info = _capture_info(stream)
    return None if info is None else info[1]


def graph_nodes(graph: int) -> dict[str, int] | None:
    """The nodes of a ``cudaGraph_t`` by type (``NODE_TYPES``), or None
    without a card or when libcuda refuses."""
    lib = _libcuda()
    if lib is None or not graph:
        return None
    g = ctypes.c_void_p(graph)
    n = ctypes.c_size_t()
    if lib.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        return None
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if lib.cuGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        return None
    counts: dict[str, int] = {}
    kind = ctypes.c_int()
    for i in range(n.value):
        if lib.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]), ctypes.byref(kind)) != 0:
            return None
        name = NODE_TYPES.get(kind.value, "other")
        counts[name] = counts.get(name, 0) + 1
    return counts


def capture_nodes() -> dict[str, int] | None:
    """The nodes captured so far on the current stream's capture, by type."""
    if _libcuda() is None:
        return None
    info = _capture_info(torch.cuda.current_stream().cuda_stream)
    return None if info is None else graph_nodes(info[0])


# ---- reading -----------------------------------------------------------------

def clear() -> None:
    """Drop every span, call record and stage total (the counters stay).
    What the programs' calls before it would still add is dropped too."""
    _T.reset()


def snapshot() -> dict:
    """The records held in memory and the counters, as plain data. Waits for
    the last replay of every traced program and for eager stages on the card,
    and adds them first.

    - ``spans``: dicts of ``name``, ``id``, ``parent`` (-1 at a root),
      ``root``, ``start_ns``, ``end_ns`` (0 while open), in opening order;
      ``dropped_spans`` counts those past ``SPAN_CAPACITY``;
    - ``calls``: per replayed call of a traced program, its ``root`` span id,
      ``function``, ``copy_in_ms``, ``replay_ms``, ``clone_ms`` and ``gap_ms``
      (device time from the program's previous call's end, None for the first
      call after ``clear()``);
    - ``stages``: per name, ``count``, ``ms`` and ``self_ms`` totals;
    - ``last_stages``: per traced program's function, its last replay's
      stages (``name``, ``start_ms`` and ``end_ms`` from the graph's first
      stamp, ``parent`` index or -1);
    - ``programs``: per captured program, ``function``, ``traced``,
      ``replays`` and ``nodes`` by type (None without a card; a traced
      program's stamp kernels under ``stamp``, not ``kernel``);
    - ``counters``: ``jit.captures``, ``jit.replays``, ``jit.evictions`` (all
      functions) and ``by_function``; ``launches`` per kernel name.
    """
    from .build import launch_counts
    from .jit import GraphJit

    functions = list(GraphJit.instances)
    programs, last = [], {}
    for fn in functions:
        for program in fn.programs.values():
            t = program.trace
            if t is not None:
                t.flush()
                if t.last is not None:
                    last[fn.__name__] = t.last[0].as_records(t.last[1])
            programs.append({"function": fn.__name__, "traced": t is not None,
                             "replays": program.replays, "nodes": program.nodes})
    _T.read_pending()
    spans = [{"name": _T.names[i], "id": i, "parent": _T.parent[i], "root": _T.root[i],
              "start_ns": _T.start[i], "end_ns": _T.end[i]} for i in range(_T.n)]
    by_function = {}
    for fn in functions:
        c = by_function.setdefault(fn.__name__, {"captures": 0, "replays": 0, "evictions": 0})
        c["captures"] += fn.captures
        c["replays"] += fn.replays
        c["evictions"] += fn.evictions
    launches: dict[str, int] = {}
    for k, n in launch_counts().items():
        launches[k.name] = launches.get(k.name, 0) + n
    return {
        "enabled": _on,
        "spans": spans,
        "dropped_spans": _T.dropped,
        "calls": [dict(zip(("root", "function", "copy_in_ms", "replay_ms", "clone_ms",
                            "gap_ms"), c)) for c in _T.calls],
        "stages": {name: {"count": c, "ms": ms, "self_ms": own}
                   for name, (c, ms, own) in _T.stages.items()},
        "last_stages": last,
        "programs": programs,
        "counters": {f"jit.{k}": sum(c[k] for c in by_function.values())
                     for k in ("captures", "replays", "evictions")} | {"by_function": by_function},
        "launches": launches,
    }
