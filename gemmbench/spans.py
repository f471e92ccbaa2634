"""The program's own counters and spans (``tpul2_torch.trace``), reduced for the metric
readers of the dispatch, wrapper, sentinel and kernel layers.

The program keeps them in the benchmark's process, so a reader takes them from there, not
from the run's record.  The counters count every call of the run, warm calls and a CUDA
graph's capture included.  The host times come from the traced part's session that
recorded the card alone (``devtrace.traced``'s first profiler), whose host work does not
enter them; the device intervals from its session that recorded the host too (the
second), the one where the program records its CUDA events.  Each function returns None
where the program has nothing to read: a program without ``tpul2_torch.trace``, a traced
part whose calls run no Python (a CUDA graph's replays), a device interval on the CPU.
Never 0 for a share.
"""

from __future__ import annotations

from gemmbench import yardstick


def _trace():
    try:
        from tpul2_torch import trace
    except ImportError:  # a program that has no spans or counters of its own
        return None
    return trace


def sentinel_call_pct() -> float | None:
    """The calls the program sent to the vendor sentinel over all its calls, in %."""
    trace = _trace()
    calls = trace.counts("call") if trace is not None else {}
    total = sum(calls.values())
    if not total:
        return None
    return 100.0 * sum(n for (_, route), n in calls.items() if route == "sentinel") / total


def session_spans(host: bool) -> list | None:
    """The spans of the newest profiler session that recorded the host (``host`` true) or
    the card alone (false); on the CPU, whose traced part is one session that records the
    host, that session stands for the card-alone one.  Device intervals are read here,
    after the traced part's synchronize."""
    trace = _trace()
    sessions = trace.profiled_sessions() if trace is not None else []
    mine = [s for s in sessions if s.host is host]
    if not mine and not host:  # the CPU's traced part: one session, that records the host
        mine = sessions
    return mine[-1].read() if mine and mine[-1].spans else None


def self_us(spans: list, name: str) -> float:
    """Σ self time of the spans named ``name``, in µs: a span's duration less the durations
    of its child spans."""
    inner = {}
    for s in spans:
        if s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0) + s.end - s.start
    return sum(s.end - s.start - inner.get(s, 0) for s in spans if s.name == name) / 1e3


def us_per_call(name: str, per: str) -> float | None:
    """Σ self time of the spans named ``name`` over the number of spans named ``per``, in
    µs, in the card-alone session."""
    spans = session_spans(host=False)
    if spans is None:
        return None
    calls = sum(s.name == per for s in spans)
    return self_us(spans, name) / calls if calls else None


def linears(spans: list) -> dict:
    """{(m, n, k, batch): [calls, Σ least seconds, Σ device seconds]} of the launches with
    a device interval (``tl2.wrapper`` and ``tl2.sentinel``), by their call's shape; a
    batched call's least time counts every padded row (batch × M)."""
    out = {}
    for s in spans:
        if s.name in ("tl2.wrapper", "tl2.sentinel") and s.device_ms is not None:
            m, n, k, batch, _ = s.shape
            row = out.setdefault((m, n, k, batch), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += batch * yardstick.least_s(m, n, k)
            row[2] += s.device_ms / 1e3
    return out


def worst_dense_roofline_pct() -> float | None:
    """The lowest share, over the 2-D linears (batch 1), of Σ least time over Σ device
    time of the linear's calls, in %."""
    spans = session_spans(host=True)
    rows = [r for (_, _, _, batch), r in linears(spans).items() if batch == 1] if spans else []
    shares = [100.0 * least / dev for _, least, dev in rows if dev > 0]
    return min(shares) if shares else None
