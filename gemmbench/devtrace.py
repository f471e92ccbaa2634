"""The device trace of a window: ``torch.profiler`` (CUPTI) events reduced to what the
metric readers and the ``breakdown`` need.

Device events are every CUDA activity the profiler records (kernels, copies, sets) but
the benchmark's own gate (``GATE_KERNEL``, the grid's wait before a burst), which is
neither the program's work nor the vendor's.  Busy time is the union of their intervals;
kernel time the sum of their durations; the window runs from the first to the last.  A
kernel of the program's own library is one with a ``tl2_`` name (``is_program_kernel``);
every other is the vendor library's or torch's.  An idle gap is the time between two busy
intervals, named by the innermost host operation that was running at its middle.

``traced`` runs the profiled part twice: the numbers come from a run that records the
card's activity alone, so that the profiler's host work does not widen the gaps it
measures; a second run records the host's operations too, only to name the gaps.
"""

from __future__ import annotations

from typing import Callable

#: Entries of each list of the breakdown.
TOP = 10
PROGRAM_PREFIX = "tl2_"
#: ``torch.cuda._sleep``'s kernel, the grid's gate before each burst.
GATE_KERNEL = "spin_kernel"


def is_program_kernel(name: str) -> bool:
    """Whether a device kernel is the program's: its name, past a leading ``void`` and
    without its template and arguments, has a part (namespace or function) starting with
    ``tl2_``, as ``void tl2wg::tl2_wgmma_kernel<128, 128, ...>(...)`` has."""
    qualified = name.removeprefix("void ").split("<")[0].split("(")[0]
    return any(part.strip().startswith(PROGRAM_PREFIX) for part in qualified.split("::"))


def _merged(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_op_at(cpu: list, t: float) -> str:
    """The innermost host operation running at ``t`` (the latest started that has not
    ended), or 'python' where none is: the benchmark's or the program's Python."""
    best = None
    for s, e, name in cpu:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, name)
    return "python" if best is None else best[1]


def reduce(events: list) -> dict:
    """{busy_s, kernel_s, program_kernel_s, window_s, device_events, device_ops,
    idle_gaps} from the profiler's events of one window.  The window runs from the first
    device event's start to the last one's end (where there is none, over the host's
    events), on the profiler's own clock, so that busy time never exceeds it."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type != DeviceType.CUDA:
            cpu.append(span)
        elif GATE_KERNEL not in e.name:
            dev.append(span)
    merged = _merged([(s, e) for s, e, _ in dev])
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:TOP]
    cpu.sort()
    spans = dev or cpu
    return {
        "window_s": (max(e for _, e, _ in spans) - min(s for s, _, _ in spans)) / 1e6
                    if spans else 0.0,
        "device_events": len(dev),
        "busy_s": sum(e - s for s, e in merged) / 1e6,
        "kernel_s": sum(by_name.values()),
        "program_kernel_s": sum(t for n, t in by_name.items() if is_program_kernel(n)),
        "device_ops": [[name[:160], t] for name, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[_host_op_at(cpu, (s + e) / 2), g / 1e6] for g, s, e in gaps],
    }


def traced(run: Callable, cuda: bool) -> tuple:
    """Run ``run()``, a part that ends on a synchronize, under ``torch.profiler``: on the
    card once recording its activity alone, for the numbers, and once more with the host's
    operations, to name the idle gaps; on the CPU once, recording the host.  Return (the
    runs' results, the reduced trace)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        results = [run()]
    out = reduce(prof.events())
    if cuda:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            results.append(run())
        out["idle_gaps"] = reduce(prof.events())["idle_gaps"]
    return results, out
