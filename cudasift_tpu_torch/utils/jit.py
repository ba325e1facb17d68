"""One program per call: the port's counterpart of the JAX package's
``utils/jit.py``.

There ``tpu_jit`` makes a function one compiled program per (shapes,
statics), so that the host dispatches once a call. Its TPU compile flag has
no counterpart on a CUDA card; its one-program role has, as a CUDA graph.
``cuda_graph_jit`` wraps a function whose positional arguments are CUDA
tensors, tuples, lists or dataclass instances of them (a ``SiftData``), and
hashable statics (``SiftParams`` is a frozen dataclass), and keeps one
captured program per (argument structure with the tensors' shapes and
dtypes, statics, device index). An argument that holds a tensor anywhere is
taken apart (``tensors``); one that holds none is a static:

- the first call for a key runs the body eagerly on the caller's stream and
  returns that result: the run builds and loads the kernels, sets their
  shared-memory attributes and lets PyTorch allocate its scan workspaces,
  none of which may happen inside a capture. Then the body is captured under
  ``torch.cuda.graph``, on a side stream of the tensors' device, reading
  from static copies of the tensor arguments. A capture runs nothing on the
  device, so the call has launched every kernel once;
- every later call copies its tensor arguments into the static buffers on
  the caller's current stream of the tensors' device, replays the graph
  there and returns clones of the outputs, so a result the caller holds is
  never overwritten by the next call. A program's calls are ordered on the
  device whatever streams they come from: each ends by recording an event
  behind its clones, and the next call's stream waits for it before it
  touches the static buffers or the outputs;
- kernel launch counts (``utils.build.Kernel.launches``) go on meaning
  launches on the device: what each launcher counted during the capture is
  taken off again and added at every replay;
- CPU tensors never reach a graph: the wrapped function runs its body, on
  the device the caller asked for;
- a capture that fails raises; nothing carries on eagerly in its place;
- inside ``disable_graphs()`` (the role of ``jax.disable_jit()``) and while
  an outer capture is under way, wrapped functions run their bodies;
- whether ``utils.trace`` is on is part of the key: a program captured with
  tracing on carries its stage markers and times its calls, and the one
  captured with tracing off is left as it is.

Each wrapped function counts its ``captures``, ``replays`` and
``evictions`` (a program dropped for ``MAX_PROGRAMS``; a recapture after one
costs what the first call cost), and each program the nodes of its graph by
type, read at capture; ``utils.trace.snapshot()`` reads them.

Each program holds a private memory pool (at 1920 x 1080 an octave-0 DoG
stack alone is 58 MB), so a wrapped function keeps its ``MAX_PROGRAMS`` most
recently used programs and drops the oldest; ``clear_cache()`` drops all, as
``tpu_jit``'s does. A program that is dropped first waits on the host for its
last call, so no clone still reads a pool that is given back. Not
thread-safe: one host thread at a time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import weakref

import torch

from . import trace
from .build import add_launches, launch_counts

MAX_PROGRAMS = 8

_eager_depth = 0


@contextlib.contextmanager
def disable_graphs():
    """Inside the block every ``cuda_graph_jit`` function runs its body
    eagerly, whatever the device; programs already captured are kept."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def map_tensors(fn, obj):
    """``obj`` with ``fn`` applied to every tensor in it: a tensor, or a
    tuple, list, dict or dataclass instance of such; anything else is
    returned as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: map_tensors(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return obj


def tensors(obj) -> list[torch.Tensor]:
    """Every tensor in ``obj``, in the order ``map_tensors`` visits them."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in tensors(v)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors(v)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in tensors(getattr(obj, f.name))]
    return []


def _signature(obj):
    """The key of one argument: a static as it is; an argument holding
    tensors as its structure, with (shape, dtype) in place of each tensor."""
    if isinstance(obj, torch.Tensor):
        return tuple(obj.shape), obj.dtype
    if not tensors(obj):
        return obj
    if isinstance(obj, dict):
        return dict, tuple((k, _signature(v)) for k, v in obj.items())
    if isinstance(obj, (tuple, list)):
        return type(obj), tuple(_signature(v) for v in obj)
    return type(obj), tuple(_signature(getattr(obj, f.name)) for f in dataclasses.fields(obj))


def _graph_device(args) -> torch.device | None:
    """The CUDA device of the tensors in the arguments, None when they are
    on the CPU (or there are none): the body then runs as it is. Tensors on
    different devices raise."""
    devices = {t.device for t in tensors(args)}
    if len(devices) > 1:
        raise ValueError(f"tensor arguments on different devices: {sorted(map(str, devices))}")
    device = next(iter(devices), None)
    return device if device is not None and device.type == "cuda" else None


class Program:
    """One captured call of ``fn``: static input buffers, the graph, its
    outputs (in the graph's private pool), the launches that each kernel
    launcher counted during the capture, the event that marks the end of its
    last use of the buffers and the pool, its graph's nodes by type (None
    without a card) and its replays. With ``traced``, its
    ``utils.trace.ProgramTrace`` and a ``twin``: a second graph of the body
    (the static buffers and the pool shared, its own outputs), which every
    other call replays, so that a call's markers are read while the next
    call runs."""

    def __init__(self, fn, args, device: torch.device, traced: bool = False):
        self.device = device
        self.static = map_tensors(torch.clone, args)
        self.trace = trace.ProgramTrace(fn.__name__) if traced else None
        self.replays = 0
        before = launch_counts()
        with torch.cuda.device(device):
            self.graph, self.outputs, self.nodes = self._capture(
                fn, self.trace.marks[0] if traced else None)
            self.launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                             if n != before.get(k, 0)}
            self.twin = self._capture(fn, self.trace.marks[1], self.graph.pool())[:2] \
                if traced else None
        with torch.cuda.device(device):
            self.done = torch.cuda.Event()
            self.done.record()               # behind the static copies
        # The captures ran nothing on the device.
        captures = 2 if traced else 1
        add_launches({k: -n * captures for k, n in self.launches.items()})

    def _capture(self, fn, marks, pool=None):
        """(graph, outputs, nodes by type) of one capture of ``fn`` on the
        static buffers, its stages into ``marks``. The stamp kernels of the
        stages count as ``stamp``, not as ``kernel``: a traced program holds
        the kernels the program does."""
        graph = torch.cuda.CUDAGraph()
        # A side stream of the tensors' device, not the one torch.cuda.graph
        # would make once on whatever device was current first.
        with torch.cuda.graph(graph, pool=pool, stream=torch.cuda.Stream(self.device)):
            with trace.capturing(marks):
                outputs = fn(*self.static)
            nodes = trace.capture_nodes()
        if nodes is not None and marks is not None and marks.points:
            nodes["kernel"] -= len(marks.points)
            nodes["stamp"] = len(marks.points)
        return graph, outputs, nodes

    def __call__(self, args):
        t = self.trace
        with torch.cuda.device(self.device):
            # Behind the previous call, which may have been on another stream.
            self.done.wait()
            graph, outputs = self.graph, self.outputs
            if t is not None and t.begin(torch.cuda.current_stream(self.device)):
                graph, outputs = self.twin
            with trace.span("jit.copy_in"):
                for buf, a in zip(tensors(self.static), tensors(args)):
                    buf.copy_(a)
            if t is not None:
                t.mark(1)
            with trace.span("jit.replay"):
                graph.replay()
            if t is not None:
                t.mark(2)
            with trace.span("jit.clone"):
                out = map_tensors(torch.clone, outputs)
            if t is not None:
                t.mark(3)
            self.done.record()
            if t is not None:
                t.end()
        self.replays += 1
        add_launches(self.launches)
        return out

    def finish(self) -> None:
        """Wait on the host for the last call, before the program is dropped
        (a traced program reads its calls first)."""
        self.done.synchronize()
        if self.trace is not None:
            self.trace.flush()


class GraphJit:
    """A function replayed from one CUDA graph per key; see the module."""

    instances: "weakref.WeakSet[GraphJit]" = weakref.WeakSet()   # for utils.trace

    def __init__(self, fn):
        self.fn = fn
        self.programs: collections.OrderedDict = collections.OrderedDict()
        self.captures = self.replays = self.evictions = 0
        functools.update_wrapper(self, fn)
        GraphJit.instances.add(self)

    @staticmethod
    def key(args, device: torch.device) -> tuple:
        """(device index, per argument its signature: a tensor's (shape,
        dtype), a structure's type and its parts' signatures, or the
        static), and last ``"traced"`` while ``utils.trace`` is on."""
        key = (device.index,) + tuple(_signature(a) for a in args)
        return key + ("traced",) if trace.enabled() else key

    def __call__(self, *args):
        device = _graph_device(args)
        if device is None or _eager_depth or torch.cuda.is_current_stream_capturing():
            return self.fn(*args)
        key = self.key(args, device)
        program = self.programs.get(key)
        if program is None:
            with trace.span("jit.capture"):
                out = self.fn(*args)
                self.programs[key] = Program(self.fn, args, device, trace.enabled())
            self.captures += 1
            while len(self.programs) > MAX_PROGRAMS:
                self.programs.popitem(last=False)[1].finish()
                self.evictions += 1
            return out
        self.programs.move_to_end(key)
        self.replays += 1
        return program(args)

    def clear_cache(self) -> None:
        """Drop every captured program (and with it its memory pool)."""
        while self.programs:
            self.programs.popitem()[1].finish()


def cuda_graph_jit(fn) -> GraphJit:
    """Decorator: ``fn`` of CUDA tensors (alone or in tuples, lists or
    dataclass instances) and hashable statics, positional arguments only, as
    one captured program per key."""
    return GraphJit(fn)
