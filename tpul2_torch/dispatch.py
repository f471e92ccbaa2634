"""Shape-dispatched GEMM entry points.

Counterpart of ``tpul2/dispatch.py``.  ``matmul`` is the public call; the candidate
entries ``cuda_l2_h100_f32`` / ``cuda_l2_h100_bf16`` keep the harness ABI
``(a, b, b_t)`` of the reference's ``cuda_l2_<dev>_<acc>`` symbols, plus ``out=`` so the
correctness gate can hand the kernel caller memory framed by guard bands.  Their server
twins ``cuda_l2_h100_{f32,bf16}_server`` dispatch each shape's server-regime winner
(``mode='server'``); the server bench measures those.

Eager torch has no trace cache, so the JAX side's jit/epoch machinery has no counterpart.
A call resolves its config against the DB as it stands, through a memo of the decision per
shape that the DB's version keys (``resolve_config``): the resolution took more host time
than the kernel's launch at the small bring-up shapes (PERF.md).

Counted and traced here (``trace``): every call of an entry point counts by entry and
route ('ring', 'wide', 'staged', 'sentinel') where the route is decided (``_run_2d``,
``_run_batched``), and every decision of ``resolve`` by source and by memo hit or miss,
traced or not.  Each entry point asks ``trace.on()`` once; where tracing is on, the call
runs the same steps inside its spans (``_traced``): ``tl2.call`` around the call,
``tl2.dispatch`` around ``resolve``, then ``tl2.wrapper`` around the kernel's wrapper or
``tl2.sentinel`` around the vendor library's GEMM.

``matmul`` and ``batched_matmul`` are differentiable on every path the JAX ones are: the
kernels and the sentinel through ``ops.matmul.GemmVjp``; a staged config with more than one
K interval raises in the backward, as ``jax.grad`` does there (``ops.pipelined``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from tpul2_torch import trace
from tpul2_torch.autotune.db import default_db
from tpul2_torch.config import KernelConfig, heuristic_config
from tpul2_torch.ops import baselines
from tpul2_torch.ops.matmul import (ACTIVATIONS, GemmVjp, cuda_matmul_fused, records_grad,
                                    refuse_out_under_grad)
from tpul2_torch.ops.pipelined import cuda_matmul_pipelined
from tpul2_torch.trace import COUNTS

#: Most shapes the resolve memo holds; past it the memo starts empty again, so a caller
#: that sends ever new shapes does not grow it without bound.
MEMO_LIMIT = 1 << 16


MODES = ("offline", "server")


def resolve_config(m: int, n: int, k: int, acc: str = "float32",
                   in_dtype="bfloat16", mode: str = "offline") -> KernelConfig:
    """Tuning DB -> nearest tuned neighbour -> heuristic (never fails).

    ``mode='server'`` prefers the shape's server-regime winner (the ``server`` sub-entry,
    ``TuneDB.put_server``), as ``tpul2/dispatch.py`` does: the offline and the
    Poisson-arrival regimes can pick different winners.

    The DB is the H100's (``autotune.db.default_db``: ``TPUL2_TORCH_TUNEDB`` or
    ``tpul2_torch/data/tunedb_h100.json``); the JAX package's ``tunedb_v5e.json`` is TPU
    data and is never read.  With no DB file, every shape takes the heuristic, which
    never returns the vendor sentinel.  A resolved config the kernel cannot run goes to
    the sentinel (the role of the JAX out-dtype guard): one ``validate`` refuses, such as a
    staged block whose ring exceeds shared memory.  Every block edge of the JAX space
    validates (its sublane 16, its covers of M < 16, of N < 128 and of unaligned
    dimensions, bn up to 32768, staged wide blocks), and every config ``validate`` takes
    launches at every shape, 2-D and batched.  An explicit ``config=`` on the entry points
    overrides all of this.

    The decision is kept in the DB's memo with the DB's version: a put or a load of the
    DB, ``reset_default_db()`` or a change of ``TPUL2_TORCH_TUNEDB`` (a new default DB)
    makes it stale, so it is never served from entries that have changed.  The memo keys
    on the mode as well.

    Counted (``trace.COUNTS``), traced or not: each call as a memo hit or miss, and each
    decision a miss takes by its source (``resolve``).  The entry points trace it as
    ``tl2.dispatch`` where tracing is on."""
    return resolve(m, n, k, acc, in_dtype, mode)[0]


def resolve(m: int, n: int, k: int, acc: str = "float32", in_dtype="bfloat16",
            mode: str = "offline") -> tuple:
    """(config, memo hit, source): ``resolve_config``'s decision, whether its memo served
    it, and where the decision came from: 'server_entry', 'entry', 'neighbour',
    'heuristic', or 'validate' where ``validate`` refused the config found and the call
    goes to the sentinel.  A memo hit keeps its decision's source."""
    db = default_db()
    key = (m, n, k, acc, in_dtype, mode)
    version = db.version
    hit = db.memo.get(key)
    if hit is not None and hit[0] == version:
        COUNTS["memo", "hit"] += 1
        return hit[1], True, hit[2]
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    COUNTS["memo", "miss"] += 1
    cfg = None
    if mode == "server":
        sub = db.get_server_entry(m, n, k, acc, in_dtype)
        if sub is not None:
            cfg, source = KernelConfig(**sub["config"]), "server_entry"
    if cfg is None:
        cfg, source = db.get(m, n, k, acc, in_dtype), "entry"
    if cfg is None:
        cfg, source = _neighbor_config(db, m, n, k, acc, in_dtype), "neighbour"
    if cfg is None:
        cfg, source = heuristic_config(m, n, k, acc), "heuristic"
    if cfg.validate() is not None:
        cfg, source = KernelConfig.vendor(), "validate"
    COUNTS["resolve", source] += 1
    if len(db.memo) >= MEMO_LIMIT:
        db.memo.clear()
    db.memo[key] = (version, cfg, source)
    return cfg, False, source


def _nearest_entry(db, m, n, k, acc, in_dtype="bfloat16", max_ratio: float = 2.0):
    """(shape, entry) of the nearest tuned neighbour, or None: within ``max_ratio`` on
    every dimension, nearest in log space, every measured entry ahead of those stored
    with ``"measured": false`` (a server-only shape carries no offline measurement), as
    in ``tpul2/dispatch.py``."""
    best = None
    for (em, en, ek), entry in db.entries_near(m, n, k, acc, in_dtype, max_ratio=max_ratio):
        dist = sum(abs(math.log(max(e, q) / min(e, q)))
                   for e, q in ((em, m), (en, n), (ek, k)))
        rank = (not entry.get("measured", True), dist)
        if best is None or rank < best[0]:
            best = (rank, (em, en, ek), entry)
    return None if best is None else best[1:]


def _neighbor_config(db, m, n, k, acc, in_dtype="bfloat16",
                     min_speedup: float = 1.05) -> Optional[KernelConfig]:
    """The nearest tuned neighbour's config (``_nearest_entry``) adapted to (m, n, k), or
    None.  A sentinel winner carries over as it is; a kernel winner whose stored speedup
    over torch_matmul is below ``min_speedup`` (within noise) gives way to its family's
    sentinel; a kernel winner that does not re-fit onto the new shape
    (``transfer._adapt`` returns None when ``validate`` fails) gives way to the sentinel
    too."""
    near = _nearest_entry(db, m, n, k, acc, in_dtype)
    if near is None:
        return None
    src, entry = near
    cfg = KernelConfig(**entry["config"])
    if cfg.use_vendor:
        return cfg
    sentinel = KernelConfig.vendor(cfg.vendor_variant)
    if entry.get("speedup_vs_torch_matmul", 1.0) < min_speedup:
        return sentinel
    from tpul2_torch.autotune.transfer import _adapt
    adapted = _adapt(cfg, src, (m, n, k))
    return adapted if adapted is not None else sentinel


def config_source(m: int, n: int, k: int, acc: str = "float32", in_dtype="bfloat16",
                  mode: str = "offline") -> dict:
    """Where ``resolve_config``'s decision for the shape comes from, in its order:
    ``{"source": "server_entry" | "entry" | "neighbour" | "heuristic"}``, with the
    entry's ``scope`` (e.g. ``heal_demote``) and, for a neighbour, the shape it was
    transferred from.  Not memoized: a record of the decision, off the call path."""
    db = default_db()
    if mode == "server" and db.get_server_entry(m, n, k, acc, in_dtype) is not None:
        return {"source": "server_entry"}
    entry = db.get_entry(m, n, k, acc, in_dtype)
    if entry is not None:
        return {"source": "entry", "scope": entry.get("scope")}
    near = _nearest_entry(db, m, n, k, acc, in_dtype)
    if near is not None:
        return {"source": "neighbour", "from": list(near[0]), "scope": near[1].get("scope")}
    return {"source": "heuristic"}


def _vendor_product(variant: str, activation, out_dtype, a, rhs, bias):
    """The sentinel's output: a library GEMM of a and rhs (b, or b_t for a '*_tn' variant),
    then the epilogue on the f32 sum like the kernel's."""
    b, b_t = (rhs.t(), rhs) if variant.endswith("_tn") else (rhs, None)
    if bias is None and activation is None:
        return baselines.vendor_product(variant, a, b, b_t, out_dtype)
    res = baselines.vendor_product(variant, a, b, b_t, torch.float32)
    if bias is not None:
        res = res + bias.float()
    return ACTIVATIONS[activation](res).to(out_dtype)


def _vendor(a, b, b_t, cfg: KernelConfig, bias, activation, out_dtype, out):
    """The sentinel.  Under autograd it goes through ``GemmVjp`` like the kernels: the
    JAX package's sentinel is differentiated by XLA, and ``aten::mm.dtype`` (its f32 output
    here) has no derivative in torch."""
    tn = cfg.vendor_variant.endswith("_tn")
    rhs = (b_t if b_t is not None else b.t()) if tn else b
    if records_grad(a, rhs, bias):
        refuse_out_under_grad(out, "matmul")
        forward = functools.partial(_vendor_product, cfg.vendor_variant, activation,
                                    out_dtype)
        return GemmVjp.apply(a, rhs, bias, forward, "nk" if tn else "kn", activation)
    res = _vendor_product(cfg.vendor_variant, activation, out_dtype, a, rhs, bias)
    return res if out is None else out.copy_(res)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           acc: str = "float32",
           out_dtype: Optional[torch.dtype] = None,
           config: Optional[KernelConfig] = None,
           bias: Optional[torch.Tensor] = None,
           activation: Optional[str] = None,
           b_t: Optional[torch.Tensor] = None,
           out: Optional[torch.Tensor] = None,
           mode: str = "offline") -> torch.Tensor:
    """Tuned C = act(A @ B + bias).  a (M, K) and b (K, N) bf16, bias f32 (N,) or None.

    acc: 'float32' or 'bfloat16' accumulator family.  ``config`` overrides resolution.
    b_t: optional (N, K) RHS, read with no copy when the config's rhs_layout is 'nk'.
    out: optional caller tensor the result is written into.
    mode: 'offline' or 'server', which regime's tuned winner to dispatch."""
    return _matmul("matmul", a, b, acc, out_dtype, config, bias, activation, b_t, out, mode)


def _matmul(entry: str, a, b, acc, out_dtype, config, bias, activation, b_t, out, mode):
    """``matmul`` for the entry point ``entry`` (its counter's and its span's name)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)} "
                         "(expected (M, K) @ (K, N))")
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or (out.dtype if out is not None else a.dtype)
    if trace.on():
        return _traced(entry, a, (m, n, k, 1, acc), config, mode,
                       lambda cfg: _route_2d(cfg, bias, activation, m, n, k),
                       lambda route, cfg: _run_2d(entry, route, a, b, b_t, cfg, bias,
                                                  activation, out_dtype, out))
    if config is None:
        config = resolve_config(m, n, k, acc, mode=mode)
    return _run_2d(entry, _route_2d(config, bias, activation, m, n, k), a, b, b_t, config,
                   bias, activation, out_dtype, out)


def _route_2d(config: KernelConfig, bias, activation, m: int, n: int, k: int) -> str:
    """The route of a 2-D call at ``config``: 'sentinel'; 'staged', the staged K ring (the
    kStage axis, ops/pipelined.py), which takes no epilogue and blocks that divide the
    shape; else the ring or, at a wide block, the wide walk."""
    if config.use_vendor:
        return "sentinel"
    if (config.pipeline_depth >= 2 and bias is None and activation is None
            and m % config.bm == 0 and n % config.bn == 0 and k % config.bk == 0):
        return "staged"
    return "wide" if config.wide else "ring"


def _run_2d(entry: str, route: str, a, b, b_t, config: KernelConfig, bias, activation,
            out_dtype, out):
    """Run a 2-D call on its route, counted by entry point and route."""
    COUNTS["call", entry, route] += 1
    if route == "sentinel":
        return _vendor(a, b, b_t, config, bias, activation, out_dtype, out)
    if route == "staged":
        rhs = ((b_t if b_t is not None else b.t().contiguous())
               if config.rhs_layout == "nk" else b)
        return cuda_matmul_pipelined(a, rhs, config, out_dtype=out_dtype, out=out)
    if config.pipeline_depth >= 2:  # the other kernels have no stages (as in the JAX package)
        config = dataclasses.replace(config, pipeline_depth=0)
    # the RHS in the config's layout (b_t read with no copy where given), then the kernel,
    # with the epilogue where there is one
    return cuda_matmul_fused(a, b, bias=bias, activation=activation, config=config,
                             out_dtype=out_dtype, out=out, b_t=b_t)


def batched_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   acc: str = "float32",
                   out_dtype: Optional[torch.dtype] = None,
                   config: Optional[KernelConfig] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tuned C[t] = A[t] @ B[t].  a (B, M, K), b (B, K, N).  Configs key on (M, N, K).

    The resolved config runs the batched kernel, a wide block included (as JAX's
    ``batched_matmul`` runs its Pallas kernel at any resolved config), with the config's bk
    and so its rounding points; only the sentinel goes to the library's bmm."""
    if (a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[1]):
        raise ValueError(f"batched_matmul shape mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} (expected (B, M, K) @ (B, K, N))")
    batch, m, k = a.shape
    n = b.shape[2]
    out_dtype = out_dtype or (out.dtype if out is not None else a.dtype)
    if trace.on():
        return _traced("batched_matmul", a, (m, n, k, batch, acc), config, "offline",
                       _route_batched,
                       lambda route, cfg: _run_batched(route, a, b, cfg, out_dtype, out))
    if config is None:
        config = resolve_config(m, n, k, acc)
    return _run_batched(_route_batched(config), a, b, config, out_dtype, out)


def _route_batched(config: KernelConfig) -> str:
    if config.use_vendor:
        return "sentinel"
    return "wide" if config.wide else "ring"


def _run_batched(route: str, a, b, config: KernelConfig, out_dtype, out):
    """Run a batched call on its route, counted as the 2-D ones."""
    from tpul2_torch.ops.batched import cuda_batched_matmul
    COUNTS["call", "batched_matmul", route] += 1
    if route == "sentinel":
        if records_grad(a, b):
            refuse_out_under_grad(out, "batched_matmul")
            return GemmVjp.apply(a, b, None, lambda a_, b_, _: baselines.vendor_bmm(
                a_, b_, out_dtype), "kn", None)
        res = baselines.vendor_bmm(a, b, out_dtype)
        return res if out is None else out.copy_(res)
    config = dataclasses.replace(config, pipeline_depth=0)  # the batched kernel has no stages
    return cuda_batched_matmul(a, b, config=config, out_dtype=out_dtype, out=out)


def _traced(entry: str, a, shape: tuple, config: Optional[KernelConfig], mode: str,
            route_of, run):
    """A call with tracing on: the untraced call's steps (``resolve``, ``route_of(config)``,
    ``run(route, config)``) inside its spans."""
    m, n, k, _, acc = shape
    with trace.Call(entry, *shape) as c:
        if config is None:
            with trace.span(c, "tl2.dispatch") as s:
                config, hit, s.info["source"] = resolve(m, n, k, acc, mode=mode)
                s.info["memo"] = "hit" if hit else "miss"
        route = route_of(config)
        if route == "sentinel":
            layer = trace.span(c, "tl2.sentinel", a.get_device(), route=route,
                               variant=config.vendor_variant)
        else:
            layer = trace.span(c, "tl2.wrapper", a.get_device(), route=route,
                               tile=(config.bm, config.bn, config.bk))
        with layer:
            return run(route, config)


def cuda_l2_h100_f32(a, b, b_t, out=None):
    """Candidate entry, f32-accumulator family (reference ``cuda_l2_h100_fp32``)."""
    return _matmul("cuda_l2_h100_f32", a, b, "float32", None, None, None, None, b_t, out,
                   "offline")


def cuda_l2_h100_bf16(a, b, b_t, out=None):
    """Candidate entry, bf16-accumulator family."""
    return _matmul("cuda_l2_h100_bf16", a, b, "bfloat16", None, None, None, None, b_t, out,
                   "offline")


def cuda_l2_h100_f32_server(a, b, b_t, out=None):
    """Server twin of ``cuda_l2_h100_f32``: each shape's server-regime winner."""
    return _matmul("cuda_l2_h100_f32_server", a, b, "float32", None, None, None, None, b_t,
                   out, "server")


def cuda_l2_h100_bf16_server(a, b, b_t, out=None):
    """Server twin of ``cuda_l2_h100_bf16``."""
    return _matmul("cuda_l2_h100_bf16_server", a, b, "bfloat16", None, None, None, None, b_t,
                   out, "server")


_CANDIDATES = {("float32", "offline"): cuda_l2_h100_f32,
               ("bfloat16", "offline"): cuda_l2_h100_bf16,
               ("float32", "server"): cuda_l2_h100_f32_server,
               ("bfloat16", "server"): cuda_l2_h100_bf16_server}


def candidate_fn(acc: str = "float32", mode: str = "offline"):
    return _CANDIDATES[(acc, mode)]
