"""One run of a cell: set-up, the window, the traced part, the check, the result line.

``run`` is the whole run but the look for a card, so that the tests drive it on the CPU
with the program's plain versions.  The program is reached only through its entry
(``tpul2_torch.dispatch``, named by the workload's ``call``) and its dispatch decision
(``resolve_config``, read once per shape at set-up for the vendor share and the check's
sample); the reference (``reference.py``) recomputes every kept output from the inputs
the benchmark made.
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gemmbench import devtrace, reference, spec, traffic, window, yardstick

#: The pass and step tags of the traced run's profiled part: places in the seeded order
#: that the window's own passes and steps do not reach.
TRACE_TAG = 1 << 20


@dataclass
class Record:
    """What the metric readers read."""
    setup_s: float
    win: window.Window
    trace: Optional[dict]
    peaks: Optional[yardstick.Peaks]


def entries_of(call: dict) -> dict:
    """The program's entries the workload names, with its keyword arguments bound: the
    ``dense`` one (``entry``) and, where the workload has grouped linears, the
    ``grouped`` one."""
    from tpul2_torch import dispatch
    out = {}
    for kind, key in (("dense", "entry"), ("grouped", "grouped_entry")):
        if key in call:
            fn = getattr(dispatch, call[key])
            out[kind] = functools.partial(fn, **call["kwargs"]) if call.get("kwargs") else fn
    return out


def route_class(cfg, k: int) -> tuple:
    """What tells one of the program's routes from another for the check's sample: the
    sentinel's variant, or the kernel's block, K interval, whether K is carried, depth,
    layout and family."""
    if cfg.use_vendor:
        return ("vendor", cfg.vendor_variant)
    return ("kernel", cfg.bm, cfg.bn, cfg.bk, k > cfg.bk, cfg.pipeline_depth,
            cfg.rhs_layout, cfg.acc_dtype)


class _Grid:
    """Set-up, window, profiled part and kept outputs of a ``grid_bursts`` cell."""

    def __init__(self, wl: dict, seed: int, device, clock, entries: dict, acc: str,
                 seconds: float, trace: bool):
        from tpul2_torch.dispatch import resolve_config
        cfg = wl["config_spec"]
        self.wl, self.seed, self.clock = wl, seed, clock
        self.entry = entry = entries["dense"]
        self.tr = traffic.make_grid(cfg, wl, seed, device)
        shapes = self.tr.shapes
        decisions = [resolve_config(m, n, k, acc) for m, n, k in shapes]
        self.vendor = np.array([d.use_vendor for d in decisions])
        classes = {i: route_class(d, shapes[i][2]) for i, d in enumerate(decisions)}
        chk = wl["check"]
        self.plan = traffic.grid_sample(seed, shapes, classes, chk["extra_shapes"],
                                        self.tr.burst_calls, chk["max_kept_bytes"])
        self.warm = window.Window()
        for m, n, k in shapes:  # one warm call of every shape
            b, b_t = self.tr.b_sets[k, n][0]
            window.call_counted(self.warm, entry, self.tr.next_a(m, k)[1], b, b_t)
        self.tr.cursor = 0
        clock.sync()

    def window(self, seconds: float) -> window.Window:
        return window.grid_window(self.tr, self.entry, self.seed, self.clock, seconds,
                                  self.vendor, self.plan, 0)

    def profiled(self) -> window.Window:
        return window.grid_window(self.tr, self.entry, self.seed, self.clock, math.inf,
                                  self.vendor, {}, TRACE_TAG, max_bursts=len(self.tr.shapes))

    def checks(self, win: window.Window):
        """(what each kept output is, A, B, the output) for the reference."""
        for idx, (c, off, s) in sorted(win.kept.items()):
            m, n, k = self.tr.shapes[idx]
            yield f"{m}x{n}x{k}", self.tr.a_at(off, m, k), self.tr.b_sets[k, n][s][0], c


class _Layers:
    """Set-up, window, profiled part and kept outputs of a ``layer_steps`` cell: steps of
    one layer, dispatched ahead, or with the workload's ``graph`` whole steps of every
    layer replayed from a CUDA graph."""

    def __init__(self, wl: dict, seed: int, device, clock, entries: dict, acc: str,
                 seconds: float, trace: bool):
        from tpul2_torch.dispatch import resolve_config
        cfg = wl["config_spec"]
        self.wl, self.clock, self.entries = wl, clock, entries
        self.tr = tr = traffic.make_layers(cfg, wl, seed, device)
        self.vendor = [resolve_config(tr.rows(lin), lin["n"], lin["k"], acc).use_vendor
                       for lin in tr.linears]
        self.kept_layers = traffic.layer_sample(seed, tr.layers, wl["check"]["layers_kept"])
        self.warm = window.Window()
        window.layer_calls(tr, entries, tr.first_layer, 0, self.warm, False)  # every shape
        self.step = None
        if wl.get("graph"):
            self.step = window.WholeStep(tr, entries, clock, self.kept_layers)
            self.warm.calls += self.step.win.calls
            self.warm.failed += self.step.win.failed
            self.warm.errors += self.step.win.errors
            least_step_s = self.step.least_s
        else:
            least_step_s = window.step_work(tr, tr.first_layer)[1]
        # the step events a window of ``seconds`` needs, where this run times its steps
        self.events = None
        if wl["step_events"] == "always" or trace:
            self.events = window.layer_events(clock, seconds, least_step_s)
        clock.sync()

    def window(self, seconds: float) -> window.Window:
        if self.step is not None:
            return window.whole_step_window(self.step, self.clock, seconds, self.vendor,
                                            events=self.events)
        return window.layer_window(self.tr, self.entries, self.clock, seconds, self.vendor,
                                   self.kept_layers, 0, events=self.events)

    def profiled(self) -> window.Window:
        if self.step is not None:
            return window.whole_step_window(self.step, self.clock, math.inf, self.vendor,
                                            max_steps=self.wl["trace_steps"])
        return window.layer_window(self.tr, self.entries, self.clock, math.inf, self.vendor,
                                   [], TRACE_TAG, max_steps=self.wl["trace_steps"])

    def checks(self, win: window.Window):
        """(what each kept output is, A, B, the output); of a grouped linear each held
        expert's routed rows, the rows that pad its batch left out."""
        for (layer, j), (c, s) in sorted(win.kept.items()):
            lin = self.tr.linears[j]
            a, w = self.tr.acts[s][j], self.tr.weights[layer][j]
            what = f"layer{layer}.{lin['name']}"
            if not lin.get("grouped"):
                yield what, a, w, c
                continue
            for e, rows in enumerate(self.tr.loads[layer]):
                yield f"{what}.expert{e}", a[e, :rows], w[e], c[e, :rows]


LOOPS = {"grid_bursts": _Grid, "layer_steps": _Layers}


def run(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, call: str = "call", root: Path = spec.ROOT) -> dict:
    """One run of cell ``name``: {"result": the result line's object, "errors": the first
    failed calls' messages, "gaps" and "rel_errs": each kept output's widest gap and
    relative error (``reference.compare``), "setup_s", "marks": when the imports and the
    traffic's set-up ended, "gate_misses"}.  ``call`` names the workload's entries to
    drive: ``call`` (the program) or ``control`` (the program's path in the precision
    below the configuration's).  "gate_misses" names the grid's shapes whose gate ended
    before their burst was enqueued."""
    wl = spec.workload(name, root)
    readers = spec.cell_readers(wl, trace, root)
    clock = window.Clock(device)
    cfg_call = wl[call]
    marks = {"imports": time.perf_counter() - t_start}
    loop = LOOPS[wl["loop"]](wl, seed, device, clock, entries_of(cfg_call), cfg_call["acc"],
                             seconds, trace)
    setup_s = marks["traffic_and_warm"] = time.perf_counter() - t_start
    win = loop.window(seconds)
    # the warm calls' failures, and the profiled parts', count with the window's
    parts = [loop.warm]
    result_trace = None
    if trace:
        profiled, result_trace = devtrace.traced(loop.profiled, clock.cuda)
        result_trace["least_s"] = profiled[0].least_s
        parts += profiled
    attempted = win.calls + sum(p.calls for p in parts)
    win.failed += sum(p.failed for p in parts)
    win.errors += [e for p in parts for e in p.errors]
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    if result_trace is not None:
        dev["busy_s"] = result_trace["busy_s"]
        dev["window_s"] = result_trace["window_s"]
    rec = Record(setup_s, win, result_trace, yardstick.PEAKS.get(kind))
    metrics = {}
    for metric, reader in readers.items():
        value = reader.read(rec)
        if value is not None:
            metrics[metric] = {"value": value, "unit": reader.UNIT}
    # the check: the window has closed and the peak is read
    readings = {what: reference.compare(c, a, b) for what, a, b, c in loop.checks(win)}
    worst = {key: max((r[i] for r in readings.values()), default=math.inf)
             for i, key in enumerate(reference.READINGS)}
    checks = {key: (worst[key], lim) for key, lim in wl["limits"].items()}
    checks["failed_calls"] = (win.failed, 0)
    out = {"correct": bool(readings) and all(v <= lim for v, lim in checks.values()),
           "attempted": attempted, "failed": win.failed, "metrics": metrics, "device": dev}
    if result_trace is not None:
        out["breakdown"] = {"device_ops": result_trace["device_ops"],
                            "idle_gaps": result_trace["idle_gaps"]}
    out["checked"] = len(readings)
    # a reading that is not finite (a NaN or a wrong shape) reads as null: JSON has no inf
    out["checks"] = {key: {"value": v if math.isfinite(v) else None, "limit": lim}
                     for key, (v, lim) in checks.items()}
    return {"result": out, "errors": win.errors,
            "gaps": {what: r[0] for what, r in readings.items()},
            "rel_errs": {what: r[1] for what, r in readings.items()},
            "setup_s": setup_s, "marks": marks,
            "gate_misses": {"x".join(map(str, loop.tr.shapes[i])): n
                            for i, n in sorted(win.gate_misses.items())}}
