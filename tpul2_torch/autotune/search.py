"""Per-shape autotuner of the H100 kernels.

Counterpart of ``tpul2/autotune/search.py``, with its method (the reference's cuBLASLt
auto-tuning loop: fresh data and a shuffled order every round, medians select):

  1. enumerate candidates (``config.candidate_configs``, seed configs first),
  2. launch screen: call each once; drop only what the wrapper refuses before any work
     runs (``ValueError`` or ``LaunchRefused``); any other error is raised.  Then capture
     each candidate's ``GraphTimer``; a candidate whose capture raises is refused too,
     with its reason,
  3. stage 1: a few rounds over every candidate, keep the finalists (and the
     torch_matmul sentinel, the speedup's reference),
  4. stage 2: more rounds over the finalists,
  5. exactness screen: the finalists, fastest first, on 0/1 inputs against an f32 product
     with TF32 off; the first with diff == 0 below the output's integer bound wins.  A
     rival of the torch_matmul sentinel is eligible only where it beats it by more than
     ``MARGIN`` (the +-10% run-to-run noise that ``save="improve"`` also allows): within
     it the sentinel stays, so noise never picks one library call over another,
  6. every candidate's end-to-end time per call (the offline bench's method: one call
     between CUDA events, fresh inputs, shuffled order); the winner's and the sentinel's
     are stored beside their device times, so that a reader sees where the two disagree,
  7. persist the winner (+ TFLOP/s, speedup vs torch_matmul) in the TuneDB.

Both stages rank by device time (``bench_utils.GraphTimer``, ``TIMING_REV`` 2): in a round
fresh operands, made on the device by a ``torch.Generator``, are copied into the static
operands that every candidate's two captured graphs read, and each candidate's time is
the difference of its two replays per extra call, clamped at the shape's bound; its
score is the median over rounds.  Per-call event windows (``TIMING_REV`` 1) held the
host's enqueue wherever it outlasted the kernel, and ranked two cuBLAS calls 1.30x apart
at 64x64x12288.  Counts are fixed: there is no calibration.

``mode='server'`` ranks the stage-2 finalists once more with the server bench's method
(``harness/bench_server.py``: each round one call of every finalist in a shuffled order,
each between CUDA events, then an exponential gap of mean ``1 / target_qps`` seconds) and
stores the winner as the shape's ``server`` sub-entry (``TuneDB.put_server``), which
``dispatch.resolve_config(mode='server')`` prefers; the offline entry is left as it is.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpul2_torch.autotune.db import TuneDB, default_db
from tpul2_torch.config import SPACE_REV, KernelConfig, candidate_configs
from tpul2_torch.harness import bench_utils as bu
from tpul2_torch.ops import baselines
from tpul2_torch.ops._build import LaunchRefused
from tpul2_torch.ops.matmul import cuda_matmul, cuda_matmul_tn
from tpul2_torch.ops.pipelined import cuda_matmul_pipelined
from tpul2_torch.utils.platform import check_device, device_name, nvidia_smi_name_power

#: The sentinel every speedup is measured against.
REFERENCE = "torch_matmul"
#: End-to-end calls timed for the winner and the sentinel (the offline bench's method).
E2E_ITERS = 20
#: Rounds of the server ranking (``mode='server'``): one call per finalist per round.
SERVER_ROUNDS = 40
#: How much faster than the torch_matmul sentinel a rival must be to win (and how much a
#: new winner must beat a stored one under ``save="improve"``): run-to-run noise.
MARGIN = 1.10
#: The regimes a winner is tuned for (``dispatch.MODES``, which imports this package).
MODES = ("offline", "server")


@dataclasses.dataclass
class TuneResult:
    m: int
    n: int
    k: int
    acc: str
    best: KernelConfig
    best_tflops: float
    torch_matmul_tflops: float
    speedup: float          # best vs the torch_matmul sentinel, by the ranking's times
    n_candidates: int
    n_launched: int
    elapsed_s: float
    device: str
    #: every launched candidate: {"config", "stage1_ms", "stage2_ms" (None if cut),
    #: "e2e_ms"}, and with mode='server' "server_ms" (None if not ranked)
    medians_ms: list
    #: "offline" or "server": which entry the winner went to
    mode: str = "offline"
    #: what ranked the candidates: "cuda_graph" (device time) or "host" (the CPU's clock)
    clock: str = "cuda_graph"
    #: the winner's and the sentinel's device ms (stage 2) and end-to-end ms per call
    device_ms: dict = dataclasses.field(default_factory=dict)
    e2e_ms: dict = dataclasses.field(default_factory=dict)
    #: candidates dropped by the launch screen or at capture, with their reasons
    refused: list = dataclasses.field(default_factory=list)


def _make_fn(cfg: KernelConfig, out_dtype: torch.dtype):
    """Candidate as a uniform f(a, b, b_t), the harness ABI (both RHS layouts supplied;
    the config decides which one is read)."""
    if cfg.use_vendor:
        def f(a, b, b_t):
            return baselines.vendor_product(cfg.vendor_variant, a, b, b_t, out_dtype)
    elif cfg.pipeline_depth >= 2:
        def f(a, b, b_t):
            rhs = b_t if cfg.rhs_layout == "nk" else b
            return cuda_matmul_pipelined(a, rhs, cfg, out_dtype=out_dtype)
    elif cfg.rhs_layout == "nk":
        def f(a, b, b_t):
            return cuda_matmul_tn(a, b_t, cfg, out_dtype=out_dtype)
    else:
        def f(a, b, b_t):
            return cuda_matmul(a, b, cfg, out_dtype=out_dtype)
    return f


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _describe(e: Exception) -> str:
    return f"{type(e).__name__}: {e}"


class _ShapeTuning:
    """Launch screen, capture and two-stage device-time ranking for one shape; ``finish``
    screens and persists."""

    def __init__(self, m, n, k, acc, out_dtype, device, max_candidates=48,
                 stage1_rounds=5, stage2_rounds=20, finalists=6, calls=bu.GRAPH_CALLS,
                 seed=0, seed_configs=None, verbose=False):
        self.m, self.n, self.k, self.acc = m, n, k, acc
        self.out_dtype, self.device, self.verbose = out_dtype, device, verbose
        self.t_start = time.perf_counter()
        self.rng = np.random.default_rng(seed)
        self.order_rng = random.Random(seed)

        cands = candidate_configs(m, n, k, acc, max_candidates=max_candidates)
        if seed_configs:
            cands = list(seed_configs) + [c for c in cands if c not in seed_configs]
        self.n_candidates = len(cands)

        self.static = bu.fresh_inputs(self.rng, m, n, k, device=device)
        floor = bu.bound_ms(m, n, k, out_dtype.itemsize)
        side = torch.cuda.Stream() if device == "cuda" else None
        self.launched, self.refused = [], []
        for cfg in cands:
            fn = _make_fn(cfg, out_dtype)
            try:
                fn(*self.static)
                _sync(device)
            except (ValueError, LaunchRefused) as e:  # refused before any work ran
                self._refuse(cfg, _describe(e))
                continue
            try:
                timer = bu.GraphTimer(fn, self.static, floor, calls, stream=side)
            except RuntimeError as e:  # the capture raised: this candidate cannot be timed
                self._refuse(cfg, "capture: " + _describe(e))
                continue
            self.launched.append((cfg, fn, timer))
        self.clock = "cuda_graph" if device == "cuda" else "host"
        self.ref_i = next((i for i, (c, _, _) in enumerate(self.launched)
                           if c.use_vendor and c.vendor_variant == REFERENCE), None)
        if self.ref_i is None:
            raise RuntimeError(f"the {REFERENCE} sentinel did not run: cannot tune")

        self.med1 = self._rounds(range(len(self.launched)), stage1_rounds)
        keep = set(sorted(self.med1, key=self.med1.get)[:finalists]) | {self.ref_i}
        self.med2 = self._rounds(sorted(keep), stage2_rounds)
        self.med_server: dict = {}
        self.elapsed_timing = time.perf_counter() - self.t_start

    def _refuse(self, cfg, reason: str) -> None:
        self.refused.append((cfg, reason))
        if self.verbose:
            print(f"  refused {cfg}: {reason[:160]}", file=sys.stderr)

    def _rounds(self, indices, n_rounds) -> dict:
        """Median device ms per call of each candidate over ``n_rounds`` rounds of fresh
        inputs in a shuffled order."""
        times = {i: [] for i in indices}
        order = list(indices)
        for _ in range(n_rounds):
            self.order_rng.shuffle(order)
            bu.load_inputs(self.static, bu.fresh_inputs(self.rng, self.m, self.n, self.k,
                                                        device=self.device))
            for i in order:
                times[i].append(self.launched[i][2].time_ms())
        return {i: float(np.median(t)) for i, t in times.items()}

    def _call_rounds(self, indices, n_rounds, gap=None) -> dict:
        """Median end-to-end ms of one call (``bench_utils.time_call_ms``) of each
        candidate over ``n_rounds`` rounds of fresh inputs in a shuffled order; ``gap()``,
        where given, runs after every round, as the server bench's sleep does."""
        times = {i: [] for i in indices}
        order = list(indices)
        for _ in range(n_rounds):
            self.order_rng.shuffle(order)
            data = bu.fresh_inputs(self.rng, self.m, self.n, self.k, device=self.device)
            for i in order:
                times[i].append(bu.time_call_ms(self.launched[i][1], data))
            if gap is not None:
                gap()
        return {i: float(np.median(t)) for i, t in times.items()}

    def rank_server(self, target_qps: float, n_rounds: int = SERVER_ROUNDS) -> None:
        """Rank the stage-2 finalists (the sentinel among them) by the server bench's
        per-call time: rounds of one call each, an exponential gap of mean
        1 / target_qps s after every round."""
        if target_qps <= 0:
            raise ValueError("target_qps must be > 0 in server mode")
        self.target_qps = target_qps
        gaps = np.random.default_rng((int(self.rng.integers(2**31)), 1))
        self.med_server = self._call_rounds(
            sorted(self.med2), n_rounds,
            gap=lambda: time.sleep(float(gaps.exponential(1.0 / target_qps))))

    def medians(self, e2e: dict) -> list:
        rows = []
        for i, (cfg, _, _) in enumerate(self.launched):
            row = {"config": dataclasses.asdict(cfg), "stage1_ms": self.med1[i],
                   "stage2_ms": self.med2.get(i), "e2e_ms": e2e[i]}
            if self.med_server:
                row["server_ms"] = self.med_server.get(i)
            rows.append(row)
        return rows

    def _exact_first(self, ranking: dict) -> int:
        """The fastest candidate of ``ranking`` that is exact on 0/1 inputs.

        The screen's truth is an independent product on the same device: 0/1 inputs in
        f32 with TF32 off, exact for every sum below 2^24.  Entries whose truth exceeds the
        output's integer bound (256 where bf16 rounds: the bf16 family or bf16 output) are
        masked; the density rule keeps most sums below it."""
        from tpul2_torch.harness.correctness import EXACT_BOUND, zero_one_density
        m, n, k = self.m, self.n, self.k
        bf16ish = self.acc == "bfloat16" or self.out_dtype == torch.bfloat16
        dens = zero_one_density(k, "bfloat16" if bf16ish else "float32")
        bound = float(EXACT_BOUND["bfloat16" if bf16ish else "float32"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.rng.integers(0, 2**31 - 1)))
        sa = (torch.rand((m, k), generator=gen, device=self.device) < dens).to(torch.bfloat16)
        sb = (torch.rand((k, n), generator=gen, device=self.device) < dens).to(torch.bfloat16)
        sbt = sb.t().contiguous()
        baselines.pin_precision()
        truth = sa.float() @ sb.float()
        keep = truth.abs() <= bound
        for i in sorted(ranking, key=ranking.get):
            cfg, fn, _ = self.launched[i]
            out = fn(sa, sb, sbt).float()
            if bool(torch.isfinite(out).all()):
                diff = float(torch.where(keep, (out - truth).abs(), 0.0).max())
            else:
                diff = float("inf")
            if diff == 0.0:
                return i
            if self.verbose:
                print(f"  WRONG RESULT (exactness screen, diff={diff}) {cfg}",
                      file=sys.stderr)
        raise RuntimeError("no finalist passed the exactness screen")

    def finish(self, db: Optional[TuneDB], save, mode: str = "offline") -> TuneResult:
        """Exactness screen, winner selection, end-to-end times, persist."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "server" and not self.med_server:
            raise RuntimeError("server mode: rank_server() has not run")
        m, n, k = self.m, self.n, self.k
        ranking = self.med_server if mode == "server" else self.med2
        ref_t = ranking[self.ref_i]
        best_i = self._exact_first({i: t for i, t in ranking.items()
                                    if i == self.ref_i or t * MARGIN < ref_t})
        best_cfg = self.launched[best_i][0]
        best_t = ranking[best_i]
        names = {"best": best_i, REFERENCE: self.ref_i}
        e2e = self._call_rounds(range(len(self.launched)), E2E_ITERS)
        result = TuneResult(
            m=m, n=n, k=k, acc=self.acc, best=best_cfg,
            best_tflops=bu.tflops(m, n, k, best_t),
            torch_matmul_tflops=bu.tflops(m, n, k, ref_t),
            speedup=ref_t / best_t,
            n_candidates=self.n_candidates, n_launched=len(self.launched),
            elapsed_s=time.perf_counter() - self.t_start,
            device=device_name(self.device), medians_ms=self.medians(e2e), mode=mode,
            clock=self.clock,
            device_ms={name: self.med2[i] for name, i in names.items()},
            e2e_ms={name: e2e[i] for name, i in names.items()},
            refused=[[dataclasses.asdict(c), why] for c, why in self.refused])
        if save:
            # NOT `db or default_db()`: an empty TuneDB is falsy (__len__)
            db = db if db is not None else default_db()
            extra = {"speedup_vs_torch_matmul": result.speedup,
                     "torch_matmul_tflops": result.torch_matmul_tflops,
                     "timing_rev": bu.TIMING_REV, "space_rev": SPACE_REV,
                     "clock": result.clock, "device": result.device,
                     "nvidia_smi": (nvidia_smi_name_power() if self.device == "cuda"
                                    else None),
                     "device_ms": result.device_ms, "e2e_ms": result.e2e_ms}
            if mode == "server":
                extra["server_ms"] = {name: self.med_server[i] for name, i in names.items()}
                extra["target_qps"] = self.target_qps
                db.put_server(m, n, k, best_cfg, acc=self.acc,
                              extra={"tflops": result.best_tflops, **extra})
                db.save()
            elif save != "improve" or _improves_over(db.get_entry(m, n, k, self.acc),
                                                     result.best_tflops):
                db.put(m, n, k, best_cfg, result.best_tflops, acc=self.acc, extra=extra)
                db.save()
        if self.verbose:
            print(f"tuned {m}x{n}x{k}/{self.acc} ({mode}): bm={best_cfg.bm} "
                  f"bn={best_cfg.bn} bk={best_cfg.bk} depth={best_cfg.pipeline_depth} "
                  f"vendor={best_cfg.vendor_variant if best_cfg.use_vendor else '-'} "
                  f"{result.best_tflops:.2f} TFLOP/s ({result.speedup:.3f}x vs "
                  f"{REFERENCE}, {result.device})", file=sys.stderr)
        return result

def _improves_over(stored: Optional[dict], tflops: float) -> bool:
    """``save="improve"``: persist where the shape has no entry or the new TFLOP/s beat
    the stored ones by more than the +-10% run-to-run noise margin."""
    return stored is None or tflops > stored.get("tflops", 0.0) * MARGIN


def tune_shape(m: int, n: int, k: int,
               acc: str = "float32",
               out_dtype: Optional[torch.dtype] = None,
               db: Optional[TuneDB] = None,
               device: str = "cuda",
               max_candidates: int = 48,
               stage1_rounds: int = 5,
               stage2_rounds: int = 20,
               finalists: int = 6,
               calls: tuple = bu.GRAPH_CALLS,
               seed: int = 0,
               save="improve",
               seed_configs: Optional[list] = None,
               mode: str = "offline",
               target_qps: float = 100.0,
               verbose: bool = False) -> TuneResult:
    """Search the config space for one (M, N, K, acc); record the winner.

    save: True (always persist), False (measure only) or "improve" (persist only when the
    shape is untuned or the new TFLOP/s beat the stored ones by more than 10%); a server
    winner is always stored when saving.
    calls: the two call counts of each candidate's ``GraphTimer``.
    mode: 'offline' (the entry) or 'server' (the ``server`` sub-entry, ranked with
    ``target_qps``).
    device: 'cuda' (raises without a card) or 'cpu' (the plain versions, timed on the
    host clock; such entries name the device 'cpu')."""
    check_device(device, "the tuner times the card's kernels")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "server" and target_qps <= 0:
        raise ValueError("target_qps must be > 0 in server mode")
    st = _ShapeTuning(m, n, k, acc, out_dtype or torch.bfloat16, device,
                      max_candidates=max_candidates, stage1_rounds=stage1_rounds,
                      stage2_rounds=stage2_rounds, finalists=finalists, calls=calls,
                      seed=seed, seed_configs=seed_configs, verbose=verbose)
    if mode == "server":
        st.rank_server(target_qps)
    return st.finish(db, save, mode)


def tune_many(shapes: Sequence[tuple],
              acc: str = "float32",
              out_dtype: Optional[torch.dtype] = None,
              db: Optional[TuneDB] = None,
              device: str = "cuda",
              skip_tuned: bool = False,
              seed_from_db: bool = True,
              save="improve",
              mode: str = "offline",
              verbose: bool = True,
              **kw) -> list:
    """Tune a batch of (M, N, K) shapes, one after another.  Resumable: with
    ``skip_tuned`` shapes already tuned in ``mode`` are skipped; an entry stored with
    ``"measured": false`` (a seeded or server-only shape) is not a tuning and is tuned,
    where the JAX package skips any stored entry.  With ``seed_from_db`` a stored config
    competes first.  ``kw`` goes to ``tune_shape``."""
    db = db if db is not None else default_db()
    results = []
    for (m, n, k) in shapes:
        stored = db.get(m, n, k, acc)
        done = (db.get_server_entry(m, n, k, acc) if mode == "server"
                else db.get_entry(m, n, k, acc))
        if skip_tuned and done is not None and done.get("measured", True):
            continue
        seeds = [stored] if (seed_from_db and stored is not None) else None
        results.append(tune_shape(m, n, k, acc=acc, out_dtype=out_dtype, db=db,
                                  device=device, save=save, seed_configs=seeds, mode=mode,
                                  verbose=verbose, **kw))
    return results
