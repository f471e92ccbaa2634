"""tpul2_torch.harness.profiling on the CPU: the roofline arithmetic, the one table of card
peaks, and the no-card answers (None shares, no trace).  Nothing here needs the card."""

import pytest
import torch

from tpul2_torch import config
from tpul2_torch.harness import bench_utils as bu
from tpul2_torch.harness import profiling as prof

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

H100 = "NVIDIA H100 80GB HBM3"


def test_h100_row_is_the_one_source():
    row = prof.DEVICE_PEAKS[H100]
    assert (row.flops, row.bytes) == (989e12, 3.35e12)
    assert (bu.PEAK_FLOPS, bu.PEAK_BYTES) == (row.flops, row.bytes)
    assert row.sms == config.NUM_SMS


@pytest.mark.parametrize("m,n,k,ms,out,want", [
    # 4096^3 bf16 out: 2·4096^3 = 1.374e11 FLOPs; 3·4096^2·2 bytes; compute-bound
    (4096, 4096, 4096, 0.2, torch.bfloat16,
     dict(tflops=687.19476736, pct_flops_peak=69.48379851971688, gb_per_s=503.31648,
          arithmetic_intensity=4096 / 3, bound="compute",
          bound_ms=2 * 4096 ** 3 / 989e12 * 1e3)),
    # 64 x 8192 x 8192 f32 out: 8.59e9 FLOPs, (64·8192 + 8192^2)·2 + 64·8192·4 bytes
    (64, 8192, 8192, 0.05, torch.float32,
     dict(tflops=171.79869184, pct_bytes_peak=100 * 137363456 / 5e-5 / 3.35e12,
          arithmetic_intensity=2 * 64 * 8192 * 8192 / 137363456, bound="memory",
          bound_ms=137363456 / 3.35e12 * 1e3)),
])
def test_roofline_hand_computed(m, n, k, ms, out, want):
    got = prof.roofline(m, n, k, ms, out_dtype=out, name=H100)
    assert got["device"] == H100 and got["ms"] == ms
    assert got["ridge_intensity"] == pytest.approx(989e12 / 3.35e12)
    for key, value in want.items():
        assert got[key] == (value if isinstance(value, str) else pytest.approx(value)), key


def test_batched_roofline_scales_with_the_batch():
    one = prof.roofline(512, 512, 128, 0.01, name=H100)
    eight = prof.roofline(512, 512, 128, 0.08, batch=8, name=H100)
    assert eight["tflops"] == pytest.approx(one["tflops"])
    assert eight["bound_ms"] == pytest.approx(8 * one["bound_ms"])


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "cpu", "NVIDIA H100 PCIe"])
def test_unknown_device_gets_no_shares(name):
    got = prof.roofline(1024, 1024, 1024, 1.0, name=name)
    assert got["pct_flops_peak"] is None and got["pct_bytes_peak"] is None
    assert got["ridge_intensity"] is None and got["bound_ms"] is None
    assert got["bound"] == "unknown" and got["tflops"] == pytest.approx(2 * 1024 ** 3 / 1e9)
    assert prof.flops_share(1e12, 1.0, name) is None
    assert prof.flops_share(989e9, 1.0, H100) == pytest.approx(1.0)


def test_maybe_trace_none_is_a_no_op():
    with prof.maybe_trace(None) as p:
        assert p is None
        x = torch.ones(4) + 1
    assert torch.equal(x, torch.full((4,), 2.0))


def test_maybe_trace_writes_a_trace(tmp_path):
    with prof.maybe_trace(str(tmp_path)) as p:
        assert p is not None
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert list(tmp_path.glob("*.json")), "no trace file"


def test_profile_step_on_the_cpu_reports_no_device_time():
    res = prof.profile_step(lambda: torch.ones(32, 32) @ torch.ones(32, 32))
    assert res["wall_ms"] > 0 and res["wall_ms_unprofiled"] > 0
    assert res["device_events"] == 0 and res["top_device_ops"] == []
    assert res["device_busy_ms"] is None and res["idle_share"] is None


def test_union_of_intervals():
    assert prof._union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert prof._union_us([]) == 0.0


def test_profile_shape_on_the_cpu(tmp_path, monkeypatch):
    from tpul2_torch.autotune import db as db_mod
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty_tunedb.json"))
    db_mod.reset_default_db()
    try:
        res = prof.profile_shape(64, 64, 64, trials=1, device="cpu")
    finally:
        db_mod.reset_default_db()
    assert res["device"] == "cpu"
    for key in ("tpul2_torch", "torch_matmul"):
        assert res[key]["clock"] == "host" and res[key]["pct_flops_peak"] is None
    assert res["speedup_vs_torch_matmul"] > 0
