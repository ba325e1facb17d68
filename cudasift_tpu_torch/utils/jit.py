"""One program per call: the port's counterpart of the JAX package's
``utils/jit.py``.

There ``tpu_jit`` makes a function one compiled program per (shapes,
statics), so that the host dispatches once a call. Its TPU compile flag has
no counterpart on a CUDA card; its one-program role has, as a CUDA graph.
``cuda_graph_jit`` wraps a function of CUDA tensors and hashable statics
(``SiftParams`` is a frozen dataclass) and keeps one captured program per
(argument shapes and dtypes, statics, device index):

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
  an outer capture is under way, wrapped functions run their bodies.

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

import torch

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


def _graph_device(args) -> torch.device | None:
    """The CUDA device of the tensor arguments, None when they are on the
    CPU (or there are none): the body then runs as it is. Tensors on
    different devices raise."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"tensor arguments on different devices: {sorted(map(str, devices))}")
    device = next(iter(devices), None)
    return device if device is not None and device.type == "cuda" else None


class Program:
    """One captured call of ``fn``: static input buffers, the graph, its
    outputs (in the graph's private pool), the launches that each kernel
    launcher counted during the capture, and the event that marks the end
    of its last use of the buffers and the pool."""

    def __init__(self, fn, args, device: torch.device):
        self.device = device
        self.static = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.device(device):
            # A side stream of the tensors' device, not the one torch.cuda.graph
            # would make once on whatever device was current first.
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(device)):
                self.outputs = fn(*self.static)
        self.launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                         if n != before.get(k, 0)}
        # The capture ran nothing on the device.
        add_launches({k: -n for k, n in self.launches.items()})
        with torch.cuda.device(device):
            self.done = torch.cuda.Event()
            self.done.record()               # behind the static copies

    def __call__(self, args):
        with torch.cuda.device(self.device):
            # Behind the previous call, which may have been on another stream.
            self.done.wait()
            for buf, a in zip(self.static, args):
                if isinstance(buf, torch.Tensor):
                    buf.copy_(a)
            self.graph.replay()
            out = map_tensors(torch.clone, self.outputs)
            self.done.record()
        add_launches(self.launches)
        return out

    def finish(self) -> None:
        """Wait on the host for the last call, before the program is dropped."""
        self.done.synchronize()


class GraphJit:
    """A function replayed from one CUDA graph per key; see the module."""

    def __init__(self, fn):
        self.fn = fn
        self.programs: collections.OrderedDict = collections.OrderedDict()
        functools.update_wrapper(self, fn)

    @staticmethod
    def key(args, device: torch.device) -> tuple:
        """(device index, per argument its (shape, dtype) or the static)."""
        return (device.index,) + tuple(
            (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a for a in args)

    def __call__(self, *args):
        device = _graph_device(args)
        if device is None or _eager_depth or torch.cuda.is_current_stream_capturing():
            return self.fn(*args)
        key = self.key(args, device)
        program = self.programs.get(key)
        if program is None:
            out = self.fn(*args)
            self.programs[key] = Program(self.fn, args, device)
            while len(self.programs) > MAX_PROGRAMS:
                self.programs.popitem(last=False)[1].finish()
            return out
        self.programs.move_to_end(key)
        return program(args)

    def clear_cache(self) -> None:
        """Drop every captured program (and with it its memory pool)."""
        while self.programs:
            self.programs.popitem()[1].finish()


def cuda_graph_jit(fn) -> GraphJit:
    """Decorator: ``fn`` of CUDA tensors and hashable statics, positional
    arguments only, as one captured program per key."""
    return GraphJit(fn)
