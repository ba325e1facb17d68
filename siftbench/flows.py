"""What every request kind shares: the spans around its calls and the base
of a flow.

A request kind is a file of its own, ``requests/<request>.py``, that defines
``REQUEST``, a subclass of ``Flow``; a traffic mix names one under
``"request"`` and the registry finds it by that name. Every flow is a closed
loop with one caller, who waits for each result before sending the next
request. A request starts when the caller hands over its input, which is
already on the card, and ends when the device has finished every output of
the request and the host holds what a caller reads back.

A flow calls the system under test through ``program``: the four entry
points that ``program.Port`` and ``program.Reference`` both expose, or, for
any other entry point, the measured package itself (``Port.package``). Each
flow keeps what a sample of the window's requests produced, and judges it
against the reference after the window (``judge``).
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch


class Spans:
    """Spans around the calls into each layer. Off (the untimed default),
    they cost a no-op context. On, each is a pair of CUDA events whose device
    time is read once its request has ended; ``calls`` counts, for each
    request, the spans it opened by name, whatever names a flow gives them."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on and device.type == "cuda"
        self.ms: dict[str, list[float]] = {}
        self.calls: list[collections.Counter] = []
        self._open: list = []
        self._pool: list = []

    @contextlib.contextmanager
    def _span(self, name: str):
        pair = self._pool.pop() if self._pool else (
            torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        yield
        pair[1].record()
        self._open.append((name, pair))

    def __call__(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()

    def collect(self) -> None:
        """Read the device time of the spans of the request that has just
        ended. An end event recorded after the request's host read may not
        have completed yet: each is waited for first."""
        if not self.on:
            return
        for name, pair in self._open:
            pair[1].synchronize()
            self.ms.setdefault(name, []).append(pair[0].elapsed_time(pair[1]))
            self._pool.append(pair)
        self.calls.append(collections.Counter(name for name, _ in self._open))
        self._open.clear()

    def clear(self) -> None:
        self.ms.clear()
        self.calls.clear()
        self._open.clear()

    def counted(self, first: int, last: int) -> collections.Counter:
        """The spans opened by requests ``first`` to ``last - 1``, by name."""
        return sum(self.calls[first:last], collections.Counter())


class Flow:
    """One traffic mix over one run's views. ``unit`` names what a request
    completes (a frame, a pair)."""

    unit = "frame"

    def __init__(self, cfg: dict, traffic: dict, views, program, spans: Spans, seed: int):
        self.cfg = cfg
        self.traffic = traffic
        self.views = views
        self.program = program
        self.spans = spans
        self.seed = seed
        self.h, self.w = cfg["frame"]["height"], cfg["frame"]["width"]
        self.log: list[dict] = []          # what the host read back, per request

    def warm(self) -> None:
        """Every shape and program the window uses, run until replayed: the
        ring's last requests, so the window starts where they stop."""
        for i in range(-int(self.traffic["warm_requests"]), 0):
            self.request(i, keep=False)
            self.spans.collect()
        self.log.clear()

    def request(self, i: int, keep: bool):
        """Request ``i``: returns what the judgement needs when ``keep``."""
        raise NotImplementedError

    def judge(self, kept: list, reference) -> list[dict]:
        """The compared numbers of each kept request, against ``reference``."""
        raise NotImplementedError

    def summary(self, kept: list) -> dict:
        """Figures printed on an earlier line (not compared)."""
        counts = [r["n"] for r in self.log if "n" in r]
        return {"mean_points": float(np.mean(counts)) if counts else None,
                "overflow_max": max((int(k["overflow"]) for k in kept), default=None)}
