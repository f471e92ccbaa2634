"""The program's counters, and spans of its call path on the profiler's clock.

**Counters.**  ``COUNTS`` is the program's one registry of counts.  It counts always,
traced or not, one key per counter:

  ("launch", key)           a kernel launch, by key of ``LAUNCHES``, counted where the
                            wrapper launches it (``ops.matmul``, ``ops.batched``,
                            ``ops.pipelined``)
  ("call", entry, route)    a call of an entry point (``matmul``, ``batched_matmul``,
                            ``cuda_l2_h100_*``) by the route dispatch gives it: 'ring',
                            'wide', 'staged' or 'sentinel'; counted where ``dispatch``
                            decides, so a call that a CUDA graph captures counts once, at
                            the capture, and not at each replay
  ("resolve", source)       a decision ``dispatch.resolve_config`` took: 'server_entry',
                            'entry', 'neighbour', 'heuristic', or 'validate' (a config
                            ``validate`` refused, sent to the sentinel)
  ("memo", "hit" | "miss")  ``resolve_config``'s memo

A harness that wants one measurement's counts takes the difference of two readings.

**Spans.**  Tracing is on while a ``torch.profiler`` records, or inside a ``recording()``
block.  Each entry point asks ``on()`` once a call; where it is off the call records no
span, reads no clock and opens no range.  Where it is on, the call records one span at
each layer boundary it crosses:

  tl2.call       the entry point, the whole call (``entry``)
  tl2.dispatch   ``resolve_config``: whether its memo served the decision (``memo``) and
                 where the decision came from (``source``, as the counter's)
  tl2.wrapper    the kernel's wrapper: ``check_operands``, the output, ``launch_args`` and
                 the ctypes launch (``route`` and ``tile``)
  tl2.sentinel   the vendor library's GEMM: ``baselines.vendor_product`` or ``vendor_bmm``,
                 with its library switch (``route`` 'sentinel', ``variant``)

Each ``Span`` holds its name, start and end (``time.perf_counter_ns``), its parent span,
the id its call's spans share, the call's shape (m, n, k, batch, acc) and those fields.
On the card, ``tl2.wrapper`` and ``tl2.sentinel`` also record a pair of pooled CUDA events
around the launch, except in a session that records the card alone: two timing events
between kernels widen the card's gaps (by ~7 us a call at the DeepSeek-V3 prefill's
linears on the H100), and such a session's device timeline stays the kernels' own.
``Session.read`` turns the events into ``device_ms``, the call's device interval, and it
is called after the caller's synchronize: the call path adds none.  Each span is also a
range of the profiler's own trace, on the clock of its device events: a host operation
(``_RecordFunctionFast``), not a user annotation, so the profiler adds no device-side
event for it, and a trace's device events stay the kernels'.  The range and the events
lie outside the span's two clock reads, so the span's time is the layer's.

**Sessions.**  Spans go to a ``Session``: each start of a profiler opens one (``host``:
whether that profiler records the host's operations), each ``recording()`` block one,
which takes the spans of its block even under a profiler.  The last ``KEEP_SESSIONS`` are
kept (``SESSIONS``); each keeps at most ``MAX_SPANS`` spans and counts those past it in
``dropped``.
"""

from __future__ import annotations

import collections
import itertools
import time
from contextlib import contextmanager
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

#: The launch counters, the keys of ``("launch", key)``: the 2-D and batched multi-K and
#: single-K bodies on each route (the ring with TMA or the loads producer; a wide block,
#: tl2_wgmma_wide.cu, with TMA or with the loads producer and predicated stores); the
#: width-32, swapped, mid-stage, streamed-A and tall-block launches of either, and those of
#: the JAX space's narrow and unaligned edges (a ring block narrower than its tile, the
#: swapped wide walk, narrow columns, a clipped wide block, more than 16384 columns); every
#: launch's store of C (by TMA from shared memory, or predicated, ``matmul.launch_store``,
#: the staged kernel's included); the staged kernel's launches on each route, with a
#: split, on a block with an edge of 32 or less, and at a wide block.
LAUNCHES = (
    *(f"{prefix}{body}_k_{route}" for prefix in ("", "batched_")
      for body in ("multi", "single")
      for route in ("wgmma", "wgmma_lsu", "wgmma_wide", "wgmma_wide_lsu")),
    "width32", "swapped", "midstage", "wide_streamed", "wide_tall", "ring_narrow",
    "wide_swapped", "wide_narrow_n", "wide_clipped", "wide_long", "c_tma_store",
    "c_predicated",
    *(f"staged_{key}" for key in ("ring", "ring_lsu", "split", "narrow", "wide")))

COUNTS: collections.Counter = collections.Counter()

#: Spans a session keeps (a traced grid part takes 12,000); those past it are counted in
#: ``Session.dropped``.
MAX_SPANS = 1 << 15
#: Sessions kept, the newest last: a traced part of the benchmark opens two.
KEEP_SESSIONS = 4


def launch_counts() -> dict:
    """The value of every launch counter, by key of ``LAUNCHES``."""
    return {key: COUNTS["launch", key] for key in LAUNCHES}


def zero_launch_counts() -> None:
    """Set every launch counter to 0."""
    for key in LAUNCHES:
        COUNTS.pop(("launch", key), None)


def counts(group: str) -> dict:
    """Every counter of ``group`` ('launch', 'call', 'resolve' or 'memo') that has counted,
    by the rest of its key: its second part, or for a 'call' (entry, route)."""
    return {key[1] if len(key) == 2 else key[1:]: n for key, n in COUNTS.items()
            if key[0] == group}


class Span:
    """One recorded span: see the module's docstring."""
    __slots__ = ("name", "call", "parent", "shape", "info", "start", "end", "events",
                 "device_ms")

    def __init__(self, name: str, call: int, parent: Optional["Span"], shape: tuple,
                 info: dict):
        self.name, self.call, self.parent = name, call, parent
        self.shape, self.info = shape, info
        self.start = self.end = None
        self.events = self.device_ms = None


#: CUDA event pairs free for a span, returned as their spans are read.
_EVENTS: list = []
#: A Stream object for each (card, raw stream) a span has recorded on: ``Event.record``
#: takes one, and ``torch.cuda.current_stream`` builds one a call (~6 us on the H100's
#: host, against ~3 us for the record itself).
_STREAMS: dict = {}


def _events(device: int) -> Optional[tuple]:
    """(a pair of timing events, card ``device``'s current stream), or None while the
    stream is captured into a CUDA graph, where an event records no time."""
    if torch.cuda.is_current_stream_capturing():
        return None
    key = (device, torch._C._cuda_getCurrentRawStream(device))
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.current_stream(device)
    if _EVENTS:
        return _EVENTS.pop(), stream
    return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)), stream


class Session:
    """The spans recorded while one profiler recorded (``kind`` 'profiler'), or in one
    ``recording()`` block ('recording')."""

    def __init__(self, kind: str, host: Optional[bool] = None):
        self.kind, self.host = kind, host
        self.spans: list = []
        self.dropped = 0

    def read(self) -> list:
        """The spans, each ``device_ms`` read from its events.  Call it once the card has
        ended the spans' work (after a synchronize): an event it has not reached reads
        nothing."""
        for s in self.spans:
            if s.events is not None:
                start, end = s.events
                try:
                    s.device_ms = start.elapsed_time(end)
                except RuntimeError:  # not reached yet, or recorded under a capture
                    pass
                _EVENTS.append(s.events)
                s.events = None
        return self.spans

    def close(self) -> None:
        """Give the spans' events back unread."""
        for s in self.spans:
            if s.events is not None:
                _EVENTS.append(s.events)
                s.events = None


SESSIONS: collections.deque = collections.deque()
#: The session of the profiler's latest start, and the open ``recording()`` blocks'.
_profiled: list = [None]
_recordings: list = []
_IDS = itertools.count(1)


def _open(session: Session) -> Session:
    if len(SESSIONS) >= KEEP_SESSIONS:
        SESSIONS.popleft().close()
    SESSIONS.append(session)
    return session


def on() -> bool:
    """Whether tracing is on: a profiler records, or a ``recording()`` block is open."""
    return _profiler._is_profiler_enabled or bool(_recordings)


@contextmanager
def recording():
    """Trace the calls of the block into a session of its own, which it yields."""
    session = _open(Session("recording"))
    _recordings.append(session)
    try:
        yield session
    finally:
        _recordings.remove(session)


def profiled_sessions() -> list:
    """The kept profiler sessions, the newest last."""
    return [s for s in SESSIONS if s.kind == "profiler"]


def _start_trace(start):
    def traced_start(self, *args, **kwargs):
        _profiled[0] = _open(Session("profiler",
                                     _profiler.ProfilerActivity.CPU in self.kineto_activities))
        return start(self, *args, **kwargs)
    traced_start.opens_session = True
    return traced_start


# Every profiler start (torch.profiler.profile and torch.autograd.profiler.profile alike)
# opens a session: the profiler keeps no handle a span could read.
if not getattr(_profiler.profile._start_trace, "opens_session", False):
    _profiler.profile._start_trace = _start_trace(_profiler.profile._start_trace)


class Call:
    """One traced call of entry point ``entry``, as a context that opens its ``tl2.call``
    span and yields itself: its session, id, shape and open span, which its inner spans
    (``span``) take."""
    __slots__ = ("session", "id", "shape", "open", "root")

    def __init__(self, entry: str, m: int, n: int, k: int, batch: int, acc: str):
        session = _recordings[-1] if _recordings else _profiled[0]
        if session is None:  # a profiler that started before this module was imported
            session = _profiled[0] = _open(Session("profiler"))
        self.session, self.id, self.open = session, next(_IDS), None
        self.shape = (m, n, k, batch, acc)
        self.root = span(self, "tl2.call", entry=entry)

    def __enter__(self) -> "Call":
        self.root.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.root.__exit__()


class span:
    """One span of ``call``, inside its open span, as a context that yields the ``Span``;
    on card ``device`` (the operands' index, -1 on the CPU) a pair of CUDA events around
    it, unless the session records the card alone."""
    __slots__ = ("call", "span", "rng", "events", "stream")

    def __init__(self, call: Call, name: str, device: int = -1, **info):
        self.call, self.span = call, Span(name, call.id, call.open, call.shape, info)
        session = call.session
        kept = len(session.spans) < MAX_SPANS
        if kept:
            session.spans.append(self.span)
        else:
            session.dropped += 1
        pair = _events(device) if device >= 0 and kept and session.host is not False else None
        self.events, self.stream = pair if pair is not None else (None, None)
        self.rng = _RecordFunctionFast(name)

    def __enter__(self) -> Span:
        self.rng.__enter__()
        if self.events is not None:
            self.events[0].record(self.stream)
        s = self.call.open = self.span
        s.start = time.perf_counter_ns()
        return s

    def __exit__(self, *exc) -> None:
        s = self.span
        s.end = time.perf_counter_ns()
        self.call.open = s.parent
        if self.events is not None:
            self.events[1].record(self.stream)
            s.events = self.events
        self.rng.__exit__(None, None, None)
