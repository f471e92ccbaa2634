"""tpul2_torch's timing and library layers on the CPU: the GraphTimer's difference
arithmetic and bound clamp, the dispatch sentinel's f32-out product against the JAX
package's ``XLA_VARIANT_FNS``, and the cuBLASLt auto-tuning baseline's CPU path and
winner selection."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpul2.ops.baselines import XLA_VARIANT_FNS
from tpul2_torch.harness import bench_utils as bu
from tpul2_torch.ops import baselines, lt_autotune

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers


# ---- GraphTimer ----

@pytest.mark.parametrize("t_lo,t_hi,n_lo,n_hi,floor,want", [
    (1.0, 5.0, 4, 20, 0.0, 0.25),      # (5 - 1) / 16
    (0.5, 0.5, 4, 20, 0.0, 0.0),        # the fixed cost alone cancels
    (1.0, 1.1, 4, 20, 0.01, 0.01),      # below the bound: clamped at it
    (2.0, 1.0, 1, 2, 0.003, 0.003),     # a negative difference is noise: clamped
])
def test_per_call_difference_and_clamp(t_lo, t_hi, n_lo, n_hi, floor, want):
    assert bu.per_call_ms(t_lo, t_hi, n_lo, n_hi, floor) == pytest.approx(want)


def test_per_call_needs_rising_counts():
    with pytest.raises(ValueError):
        bu.per_call_ms(1.0, 2.0, 4, 4, 0.0)
    with pytest.raises(ValueError):
        bu.GraphTimer(lambda *d: None, (torch.zeros(1),), calls=(5, 3))


def test_bound_is_the_larger_of_bytes_and_flops():
    # 4096^3: compute-bound, 2 * 4096^3 / 989e12 s
    assert bu.bound_ms(4096, 4096, 4096) == pytest.approx(2 * 4096**3 / 989e12 * 1e3)
    # 64x8192x8192: bytes-bound, bf16 operands read once and the bf16 output written once
    want = ((64 * 8192 + 8192 * 8192) * 2 + 64 * 8192 * 2) / 3.35e12 * 1e3
    assert bu.bound_ms(64, 8192, 8192) == pytest.approx(want)
    assert bu.bound_ms(64, 8192, 8192, out_bytes=4) > want
    assert bu.bound_ms(64, 64, 64, batch=3) == pytest.approx(3 * bu.bound_ms(64, 64, 64))


def test_graph_timer_on_cpu_takes_the_difference_on_the_host_clock(monkeypatch):
    calls = []
    clock = iter([0.0, 0.004, 1.0, 1.020])  # 4 calls in 4 ms, then 20 calls in 20 ms

    def fn(a, b, b_t):
        calls.append(a)

    monkeypatch.setattr(bu.time, "perf_counter", lambda: next(clock))
    data = bu.fresh_inputs(np.random.default_rng(0), 8, 16, 32, device="cpu")
    timer = bu.GraphTimer(fn, data, floor_ms=1e-4, calls=(4, 20))
    assert timer.clock == "host" and not timer.graphs and calls == []
    assert timer.time_ms() == pytest.approx((20.0 - 4.0) / 16)
    assert len(calls) == 24 and all(c is data[0] for c in calls)
    # fresh inputs go into the static operands the timer reads
    fresh = bu.fresh_inputs(np.random.default_rng(1), 8, 16, 32, device="cpu")
    bu.load_inputs(timer.static, fresh)
    assert all(torch.equal(s, f) for s, f in zip(timer.static, fresh))
    assert timer.static[0] is data[0]


def test_timing_revision_is_two():
    assert bu.TIMING_REV == 2 and bu.GRAPH_CALLS[1] > bu.GRAPH_CALLS[0] > 0


# ---- the dispatch sentinel's f32 output ----

def _inputs(seed, m, n, k, zero_one):
    rng = np.random.default_rng(seed)
    if zero_one:
        a, b = rng.integers(0, 2, (m, k)), rng.integers(0, 2, (k, n))
    else:
        a, b = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    # round to bf16 once, so both packages read identical values
    a = torch.from_numpy(a.astype(np.float32)).bfloat16()
    b = torch.from_numpy(b.astype(np.float32)).bfloat16()
    return a, b


@pytest.mark.parametrize("variant,xla", [("torch_matmul", "matmul"), ("cublas_nn", "dot_nn"),
                                         ("cublas_tn", "dot_tn"), ("cublaslt_nn", "dot_nn"),
                                         ("cublaslt_tn", "dot_tn")])
@pytest.mark.parametrize("zero_one", [True, False])
def test_sentinel_f32_product_matches_xla_variants(variant, xla, zero_one):
    """Exact on 0/1 inputs; on normal inputs within the f32 sum's worst-case error, K
    roundings of 2^-24 each over sum |a_i b_i| (both are f32 sums of exact products, in
    another order)."""
    m, n, k = 48, 80, 384
    a, b = _inputs(7, m, n, k, zero_one)
    b_t = b.t().contiguous()
    ours = baselines.vendor_product(variant, a, b, b_t, torch.float32)
    aj, bj = jnp.asarray(a.float().numpy(), jnp.bfloat16), jnp.asarray(b.float().numpy(),
                                                                       jnp.bfloat16)
    theirs = torch.from_numpy(np.array(XLA_VARIANT_FNS[xla](aj, bj, bj.T), np.float32))
    assert ours.dtype == torch.float32 and ours.shape == (m, n)
    if zero_one:
        assert torch.equal(ours, theirs)
    else:
        tol = k * 2.0**-24 * (a.float().abs() @ b.float().abs())
        assert bool(((ours - theirs).abs() <= tol).all())


def test_sentinel_bmm_f32_output():
    a = torch.from_numpy(np.random.default_rng(3).integers(0, 2, (2, 40, 1200))
                         .astype(np.float32)).bfloat16()
    b = torch.from_numpy(np.random.default_rng(4).integers(0, 2, (2, 1200, 24))
                         .astype(np.float32)).bfloat16()
    out = baselines.vendor_bmm(a, b, torch.float32)
    assert out.dtype == torch.float32 and torch.equal(out, a.float() @ b.float())
    assert (a.float() @ b.float()).max() > 256  # above bf16's integers: the f32 sum
    assert baselines.vendor_bmm(a, b, torch.bfloat16).dtype == torch.bfloat16


def test_vendor_variants_are_the_plain_library_calls():
    assert baselines.VENDOR_VARIANTS == ("torch_matmul", "cublas_nn", "cublas_tn",
                                         "cublaslt_nn", "cublaslt_tn")
    assert {"cublaslt_autotuned_nn", "cublaslt_autotuned_tn"} <= set(baselines.BASELINES)


# ---- the cuBLASLt auto-tuning baseline ----

def test_select_winner_takes_the_least_median():
    rounds = [[3.0, 1.0, 2.0], [3.0, 9.0, 2.0], [3.0, 1.5, 2.5]]
    best, medians = lt_autotune.select_winner(rounds)
    assert medians == [3.0, 1.5, 2.0] and best == 1
    assert lt_autotune.select_winner([[1.0, 1.0]])[0] == 0  # the first on a tie


@pytest.mark.parametrize("layout", ["nn", "tn"])
def test_autotuned_baselines_run_torch_mm_on_the_cpu(layout):
    a, b = _inputs(9, 40, 24, 72, True)
    fn = baselines.BASELINES[f"cublaslt_autotuned_{layout}"]
    out = fn(a, b, b.t().contiguous())
    assert out.dtype == torch.bfloat16 and torch.equal(out, torch.mm(a, b))
    assert torch.equal(lt_autotune.lt_matmul(a, b.t().contiguous() if layout == "tn" else b,
                                             layout, torch.float32), a.float() @ b.float())


def test_lt_search_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="layout"):
        lt_autotune.lt_matmul(torch.zeros(2, 2), torch.zeros(2, 2), "nt")
    with pytest.raises(ValueError, match="out_dtype"):
        lt_autotune._key(2, 2, 2, "nn", torch.float16)
    with pytest.raises(ValueError, match="on the card"):
        lt_autotune.search(2, 2, 2, "nn", device="cpu")
