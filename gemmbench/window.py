"""The measured window: the grid's gated bursts, steps of one layer, and whole steps
replayed from a CUDA graph, timed by CUDA events and the host clock.

A window starts on an idle card (a synchronize) and ends on a synchronize.  Nothing in it
allocates an operand or builds a kernel: the traffic's tensors are made and every shape is
warmed at set-up.  Each call's output is dropped at once, except those the check keeps.
A call that raises counts as failed and the window goes on.

On the CPU (the tests) the events are the host clock's and the synchronize does nothing:
such times describe the CPU and are never reported as device numbers.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from gemmbench import traffic, yardstick

#: A grid burst's gate: about a millisecond of the H100's clock, several times what the
#: host takes to enqueue a burst of four calls.
GATE_CYCLES = 2_000_000
#: How far the host runs ahead of the card in a stream of steps: as many steps as take
#: this long at their least time, so that the card never waits for the host and the
#: window ends within a fraction of a second of its close.
AHEAD_S = 0.1


class HostEvent:
    """A CUDA event's interface on the host clock (the CPU tests)."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


class Clock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ahead(self, least_step_s: float) -> list:
        """Marks that hold the host at most ``AHEAD_S`` of work ahead of the card: one is
        recorded after each step, and the host waits on the mark of the step that many
        steps back before it enqueues the next (nothing on the CPU)."""
        if not self.cuda:
            return []
        return [torch.cuda.Event() for _ in range(max(2, math.ceil(AHEAD_S / least_step_s)))]

    def event(self):
        if not self.cuda:
            return HostEvent()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()  # creates the CUDA event now, not inside the window
        return ev

    def gate(self, cycles: int) -> None:
        """Hold the stream for ``cycles`` of the card's clock (``torch.cuda._sleep``, the
        kernel ``devtrace.GATE_KERNEL``), so that the calls the host enqueues meanwhile
        run back to back once it ends.  Nothing on the CPU."""
        if self.cuda:
            torch.cuda._sleep(cycles)


@dataclass
class Window:
    """What one window did, for the metric readers and the check."""
    wall_s: float = 0.0
    calls: int = 0
    failed: int = 0
    flops: float = 0.0
    least_s: float = 0.0          # Σ of each call's least time (yardstick)
    vendor_calls: int = 0         # calls whose shape dispatch sends to the sentinel
    gate_misses: dict = field(default_factory=dict)  # grid shape -> bursts whose gate
    steps: int = 0                # ended before the host had enqueued them
    step_ms: list = field(default_factory=list)
    shape_flops: Optional[np.ndarray] = None
    shape_s: Optional[np.ndarray] = None
    kept: dict = field(default_factory=dict)
    errors: list = field(default_factory=list)


def _hold(marks: list, s: int) -> None:
    """Before step ``s``: wait until the card has ended step ``s - len(marks)``."""
    if marks and s >= len(marks):
        marks[s % len(marks)].synchronize()


def _mark(marks: list, s: int) -> None:
    """After step ``s``."""
    if marks:
        marks[s % len(marks)].record()


def _failed(win: Window, exc: Exception) -> None:
    win.failed += 1
    if len(win.errors) < 5:
        win.errors.append(f"{type(exc).__name__}: {exc}")


def call_counted(win: Window, entry: Callable, *args):
    """One call outside a window (a warm call): counted in ``win``, a failure too."""
    win.calls += 1
    try:
        return entry(*args)
    except Exception as exc:  # a refused launch or a fault: counted, not fatal
        _failed(win, exc)


def grid_window(tr: traffic.GridTraffic, entry: Callable, seed: int, clock: Clock,
                seconds: float, vendor: np.ndarray, kept_plan: dict, pass_tag: int,
                max_bursts: Optional[int] = None) -> Window:
    """Bursts of ``tr.burst_calls`` calls of one shape, over passes of the grid in seeded
    orders (passes ``pass_tag``, ``pass_tag`` + 1, ...), until ``seconds`` have passed or
    ``max_bursts`` bursts have run.  Each burst starts on an idle card behind a gate of
    ``GATE_CYCLES``: the host enqueues its calls while the gate holds the stream, and the
    two events around them time the calls back to back on the card.  A gate that ended
    before the host had enqueued the burst is a miss, counted by shape: that burst's time
    holds the rest of the host's enqueueing.  Each output is dropped before the next call
    and a kept shape keeps its first output, so that the caching allocator serves every
    output from a block it holds, and asks the driver for none inside the window."""
    n = len(tr.shapes)
    win = Window(shape_flops=np.zeros(n), shape_s=np.zeros(n))
    calls = np.zeros(n, dtype=np.int64)
    start, end = clock.event(), clock.event()
    burst, bursts, p = tr.burst_calls, 0, pass_tag
    clock.sync()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        for idx in traffic.pass_order(seed, n, p):
            if time.perf_counter() >= t_end or bursts == max_bursts:
                break
            m, nn, k = tr.shapes[idx]
            sets = tr.b_sets[k, nn]
            ops = [(*tr.next_a(m, k), j % len(sets)) for j in range(burst)]
            keep_at = kept_plan.get(idx)
            clock.gate(GATE_CYCLES)  # on an idle stream: the synchronize before, or below
            start.record()
            for j, (off, a, s) in enumerate(ops):
                b, b_t = sets[s]
                try:
                    c = entry(a, b, b_t)
                except Exception as exc:  # a refused launch or a fault: counted, not fatal
                    _failed(win, exc)
                    continue
                if j == keep_at and idx not in win.kept:
                    win.kept[idx] = (c, off, s)
                del c  # before the next call, so that its output takes this one's block
            end.record()
            if clock.cuda and start.query():  # the card has passed the gate
                win.gate_misses[idx] = win.gate_misses.get(idx, 0) + 1
            clock.sync()
            win.shape_s[idx] += start.elapsed_time(end) / 1e3
            calls[idx] += burst
            bursts += 1
        else:
            p += 1
            continue
        break
    win.wall_s = time.perf_counter() - t0
    for idx in np.flatnonzero(calls):
        m, nn, k = tr.shapes[idx]
        win.shape_flops[idx] = calls[idx] * yardstick.flops(m, nn, k)
        win.least_s += calls[idx] * yardstick.least_s(m, nn, k)
    win.calls = int(calls.sum())
    win.flops = float(win.shape_flops.sum())
    win.vendor_calls = int(calls[vendor].sum())
    win.steps = bursts
    return win


def step_work(tr: traffic.LayerTraffic, layer: int) -> tuple:
    """(operations, least seconds) of one layer's linears: a grouped linear counts the rows
    routed to each expert, not the rows that pad its batch."""
    fl = least = 0.0
    for lin in tr.linears:
        if lin.get("grouped"):
            fl += yardstick.grouped_flops(tr.loads[layer], lin["n"], lin["k"])
            least += yardstick.grouped_least_s(tr.loads[layer], lin["n"], lin["k"])
        else:
            fl += yardstick.flops(tr.m, lin["n"], lin["k"])
            least += yardstick.least_s(tr.m, lin["n"], lin["k"])
    return fl, least


def layer_calls(tr: traffic.LayerTraffic, entries: dict, layer: int, act_set: int,
                win: Window, keep: bool) -> None:
    """One layer's linears in order, through the entry for each kind (``dense`` or
    ``grouped``); a call that raises counts as failed."""
    w, acts = tr.weights[layer], tr.acts[act_set]
    for j, lin in enumerate(tr.linears):
        win.calls += 1
        try:
            c = entries["grouped" if lin.get("grouped") else "dense"](acts[j], w[j])
        except Exception as exc:  # a refused launch or a fault: counted, not fatal
            _failed(win, exc)
            continue
        if keep:
            win.kept[layer, j] = (c, act_set)


def layer_events(clock: Clock, seconds: float, least_step_s: float) -> list:
    """Enough events for a window of ``seconds`` of steps no shorter than the least time."""
    return [clock.event() for _ in range(int(seconds / least_step_s) + 2)]


def layer_window(tr: traffic.LayerTraffic, entries: dict, clock: Clock, seconds: float,
                 vendor: list, kept_layers: list, step_tag: int,
                 events: Optional[list] = None, max_steps: Optional[int] = None) -> Window:
    """Steps of one layer's linears, dispatched ahead (``AHEAD_S``), cycling the layers from
    ``tr.first_layer`` + ``step_tag``, until ``seconds`` have passed or ``max_steps`` steps
    have run.  With ``events``, one is recorded after each step (and one before the
    first), and a step's time runs from one to the next, so idle gaps count."""
    win = Window()
    n_layers, n_sets = tr.layers, len(tr.acts)
    if events is not None:
        max_steps = len(events) - 1 if max_steps is None else min(max_steps, len(events) - 1)
    keep = set(kept_layers)
    work = [step_work(tr, layer) for layer in range(n_layers)]
    marks = clock.ahead(min(t for _, t in work))
    s = 0
    clock.sync()
    if events is not None:
        events[0].record()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end and s != max_steps:
        layer = (tr.first_layer + step_tag + s) % n_layers
        _hold(marks, s)
        layer_calls(tr, entries, layer, s % n_sets, win, layer in keep)
        _mark(marks, s)
        win.flops += work[layer][0]
        win.least_s += work[layer][1]
        s += 1
        if events is not None:
            events[s].record()
    clock.sync()
    win.wall_s = time.perf_counter() - t0
    if events is not None:
        win.step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(s)]
    win.steps = s
    win.vendor_calls = s * sum(vendor)
    return win


class WholeStep:
    """One step of every layer's linears in layer order (layer i on activation set i
    modulo the sets), as a serving engine runs a decode step: on the card captured once as
    a CUDA graph at set-up and replayed, on the CPU run as it is each time.  ``win``
    holds what the captured step did: its calls' failures and the outputs it keeps."""

    def __init__(self, tr: traffic.LayerTraffic, entries: dict, clock: Clock,
                 kept_layers: list):
        self.tr, self.entries, self.keep = tr, entries, set(kept_layers)
        self.graph = None
        if clock.cuda:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm the step where it is captured
                self._run()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.win = self._run()
            clock.sync()
        else:
            self.win = self._run()
        work = [step_work(tr, layer) for layer in range(tr.layers)]
        self.flops = sum(f for f, _ in work)
        self.least_s = sum(t for _, t in work)

    def _run(self) -> Window:
        win = Window()
        for layer in range(self.tr.layers):
            layer_calls(self.tr, self.entries, layer, layer % len(self.tr.acts), win,
                        layer in self.keep)
        return win

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.win = self._run()


def whole_step_window(step: WholeStep, clock: Clock, seconds: float, vendor: list,
                      events: Optional[list] = None, max_steps: Optional[int] = None
                      ) -> Window:
    """Whole steps dispatched ahead (``AHEAD_S``), until ``seconds`` have passed or
    ``max_steps`` steps have run; with ``events`` timed step by step as ``layer_window``
    times its steps.  Every call of a step counts, and each that failed at the capture
    fails in every step."""
    tr = step.tr
    if events is not None:
        max_steps = len(events) - 1 if max_steps is None else min(max_steps, len(events) - 1)
    marks = clock.ahead(step.least_s)
    s = 0
    clock.sync()
    if events is not None:
        events[0].record()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end and s != max_steps:
        _hold(marks, s)
        step()
        _mark(marks, s)
        s += 1
        if events is not None:
            events[s].record()
    clock.sync()
    win = Window(wall_s=time.perf_counter() - t0, steps=s, kept=step.win.kept,
                 errors=list(step.win.errors))
    if events is not None:
        win.step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(s)]
    per_step = tr.layers * len(tr.linears)
    win.calls = s * per_step
    win.failed = s * step.win.failed
    win.flops, win.least_s = s * step.flops, s * step.least_s
    win.vendor_calls = s * tr.layers * sum(vendor)
    return win
