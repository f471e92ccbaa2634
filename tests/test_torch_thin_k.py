"""The thin-K band of tpul2_torch: the wide blocks, the roofline report and the retune,
against the JAX package's tools, on the CPU (no JAX timing loop)."""

import csv
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.ops.matmul import pallas_matmul
from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.autotune import search
from tpul2_torch.autotune.transfer import _adapt, neighbor_seed_configs
from tpul2_torch.config import (KSTEP, SMEM_LIMIT, TILE_CHOICES, WIDE_MIN_STAGES, KernelConfig,
                                candidate_configs, wide_smem_bytes, wide_stages,
                                wide_streamed)
from tpul2_torch.harness import bench_utils
from tpul2_torch.harness.profiling import DEVICE_PEAKS
from tpul2_torch.ops import batched
from tpul2_torch.ops import matmul as mm
from tpul2_torch.utils.padding import round_up

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


report = _script("thin_k_report_torch")
retune = _script("retune_thin_k_torch")
jax_report = _script("thin_k_report")
jax_retune = _script("retune_thin_k")


# ---- the report ----

def _synthetic(tmp_path, seed: int = 0):
    """The same rows in the port's CSV + sidecar and the JAX tool's: thin-K and other
    shapes, a shape measured twice (the later record counts), one with no record."""
    rng = np.random.default_rng(seed)
    dims = [64, 128, 256, 512, 2048, 4096, 16384]
    shapes = sorted({(int(rng.choice(dims)), int(rng.choice(dims)), int(rng.choice(dims)))
                     for _ in range(60)} | {(16384, 16384, 64), (2048, 64, 512)})
    ours_csv, theirs_csv = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    ours_det, theirs_det = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    with ours_csv.open("w") as fo, theirs_csv.open("w") as ft, ours_det.open("w") as do, \
            theirs_det.open("w") as dt:
        fo.write("mnk,torch.matmul,cuBLAS-nn\n")
        ft.write("mnk,jnp.matmul,xla-max\n")
        for i, (m, n, k) in enumerate(shapes):
            mnk = f"{m}x{n}x{k}"
            speedup = f"{rng.uniform(0.5, 1.3):.4f}"
            fo.write(f"{mnk},{speedup},1.0\n")
            ft.write(f"{mnk},{speedup},1.0\n")
            if i == 3:
                continue  # no record: missing
            for _ in range(2 if i % 5 == 0 else 1):
                cand, base = rng.uniform(0.01, 2.0, 2)
                do.write(json.dumps({"mnk": mnk, "device": f"{H100}, 700.00 W", "per_func": {
                    "tpul2_torch_float32": {"ms": cand}, "torch_matmul": {"ms": base}}}) + "\n")
                dt.write(json.dumps({"mnk": [m, n, k], "per_func": {
                    "tpul2_float32": {"ms": cand}, "xla_matmul": {"ms": base}}}) + "\n")
    return ours_csv, ours_det, theirs_csv, theirs_det


@pytest.mark.parametrize("seed", [0, 1])
def test_report_agrees_with_the_jax_tool(tmp_path, monkeypatch, seed):
    """The same rows through both tools, with the H100's peaks in the JAX module and its
    write-allocate doubling (wa_factor 2): the same shares to 1e-12, the same order, the
    same targets and the same missing count."""
    peaks = DEVICE_PEAKS[H100]
    monkeypatch.setattr(jax_report, "PEAK", peaks.flops)
    monkeypatch.setattr(jax_report, "HBM_BW", peaks.bytes)
    ours_csv, ours_det, theirs_csv, theirs_det = _synthetic(tmp_path, seed)
    for bars in ((0.85, 1.05), (0.3, 0.9)):
        ours = report.analyze(ours_csv, ours_det, "float32", *bars, wa_factor=2.0)
        theirs = jax_report.analyze(theirs_csv, theirs_det, "float32", *bars)
        assert ours[1] == theirs[1] and ours[2] == theirs[2]
        assert [r["mnk"] for r in ours[0]] == [r["mnk"] for r in theirs[0]]
        assert ours[0], "no thin-K row in the synthetic set"
        for o, t in zip(ours[0], theirs[0]):
            assert o["speedup"] == t["speedup"]
            for mine, jax_key in (("cand_share_naive", "cand_share_naive"),
                                  ("cand_share_wa", "cand_share_wa"),
                                  ("torch_share_wa", "xla_share_wa")):
                assert o[mine] == pytest.approx(t[jax_key], rel=1e-12, abs=0.0)


def test_report_bound_is_bench_utils_bound():
    peaks = DEVICE_PEAKS[H100]
    for m, n, k in ((16384, 16384, 64), (2048, 64, 512), (4096, 4096, 4096)):
        assert report.bound_ms(m, n, k, peaks) == pytest.approx(
            bench_utils.bound_ms(m, n, k, 2), rel=1e-12)
        wa = report.bound_ms(m, n, k, peaks, wa_factor=1.5)
        assert wa >= report.bound_ms(m, n, k, peaks)


def test_report_refuses_an_unknown_card(tmp_path):
    ours_csv, ours_det, _, _ = _synthetic(tmp_path)
    text = ours_det.read_text().replace(H100, "NVIDIA H200")
    ours_det.write_text(text)
    with pytest.raises(ValueError, match="no published peaks"):
        report.analyze(ours_csv, ours_det, "float32")
    with pytest.raises(ValueError, match="no published peaks"):
        report.card_peaks("cpu")


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_report_on_the_committed_grid(acc, capsys):
    rows, targets, missing = report.analyze(report.default_csv(acc), report.DEFAULT_DETAIL, acc)
    assert len(rows) == 300 and missing == 0
    assert all(r["cand_share_wa"] > 0 for r in rows)
    assert rows == sorted(rows, key=lambda r: r["cand_share_wa"])
    assert report.main(["--acc", acc]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["rows"], summary["missing"], summary["targets"]) == (300, 0, len(targets))
    assert summary["wa_factor"] == report.WA_FACTOR


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_committed_roofline_csvs_regenerate(acc, tmp_path, capsys):
    """eval_results/tpul2_torch_h100_thin_k_roofline_<acc>.csv is the report's output on
    the committed no-heal grid at the default write-allocate factor."""
    out = tmp_path / "rows.csv"
    assert report.main(["--acc", acc, "--out_csv", str(out)]) == 0
    committed = REPO / "eval_results" / f"tpul2_torch_h100_thin_k_roofline_{acc}.csv"
    assert out.read_text() == committed.read_text()
    with committed.open() as f:
        assert len(list(csv.DictReader(f))) == 300


# ---- the retune ----

def test_drop_rows_matches_the_jax_tool(tmp_path):
    rows = "mnk,torch.matmul\n" + "".join(f"{m}x64x64,{m / 100:.2f}\n" for m in range(1, 9))
    ours, theirs = tmp_path / "a.csv", tmp_path / "b.csv"
    for mnks in ({"2x64x64", "5x64x64", "9x64x64"}, {"0x64x64"}, set()):
        ours.write_text(rows)
        theirs.write_text(rows)
        assert retune.drop_rows(ours, mnks) == jax_retune.drop_rows(theirs, mnks)
        assert ours.read_text() == theirs.read_text()
    assert retune.drop_rows(tmp_path / "absent.csv", {"1x64x64"}) == 0


def _targets(tmp_path, shapes):
    path = tmp_path / "targets.txt"
    path.write_text("# thin-K\n" + "".join(f"{m},{n},{k}\n" for m, n, k in shapes))
    return path


def test_retune_refuses_the_committed_db_and_csvs(tmp_path, monkeypatch):
    called = []
    monkeypatch.setattr(search, "tune_shape", lambda *a, **kw: called.append(a))
    targets = _targets(tmp_path, [(4096, 4096, 64)])
    with pytest.raises(SystemExit):
        retune.main(["--targets", str(targets), "--db", str(db_mod._DATA_DIR /
                                                               "tunedb_h100.json")])
    copy = tmp_path / "db.json"
    copy.write_text((db_mod._DATA_DIR / "tunedb_h100.json").read_text())
    for committed in (REPO / "eval_results" / "tpul2_torch_h100_float32_speedup_offline.csv",
                      REPO / "eval_results" / "tpul2_torch_h100_grid_noheal"
                      / "tpul2_torch_h100_float32_speedup_offline.csv"):
        before = committed.read_text()
        with pytest.raises(SystemExit):
            retune.main(["--targets", str(targets), "--db", str(copy), "--csv",
                         str(committed)])
        assert committed.read_text() == before
    assert not called


class _Result:
    def __init__(self, best, tflops):
        self.best, self.best_tflops, self.speedup = best, tflops, 1.5
        rows = [(KernelConfig.vendor(), 1.0), (KernelConfig(bm=128, bn=2048, bk=64), 0.9),
                (KernelConfig(bm=128, bn=128, bk=64), 3.0)]
        self.medians_ms = [{"config": dataclasses.asdict(c), "stage1_ms": ms} for c, ms in rows]


def test_retune_stops_at_its_budget_and_drops_rows(tmp_path, monkeypatch, capsys):
    """A stand-in tune_shape: each shape costs 10 s of the stand-in clock; a 15 s budget
    tunes two, prints the rest as targets left, and drops the tuned rows from a copied
    CSV.  A wide winner, a ring tile and the sentinel print their kinds; a shape with no
    stored TFLOP/s prints its gain as inf."""
    clock = [0.0]
    monkeypatch.setattr(retune, "_clock", lambda: clock[0])
    winners = iter([KernelConfig(bm=128, bn=2048, bk=64), KernelConfig.vendor()])
    seen = []

    def stand_in(m, n, k, **kw):
        seen.append(((m, n, k), kw))
        clock[0] += 10.0
        return _Result(next(winners), 200.0)

    monkeypatch.setattr(search, "tune_shape", stand_in)
    shapes = [(16384, 16384, 64), (8192, 8192, 256), (4096, 4096, 128)]
    db_path = tmp_path / "db.json"
    db = db_mod.TuneDB(path=db_path)
    db.put(8192, 8192, 256, KernelConfig.vendor(), 100.0, acc="float32")
    db.save()
    csv_copy = tmp_path / "grid.csv"
    csv_copy.write_text("mnk,torch.matmul\n" + "".join(f"{m}x{n}x{k},0.5\n"
                                                       for m, n, k in shapes))
    assert retune.main(["--targets", str(_targets(tmp_path, shapes)), "--db", str(db_path),
                        "--csv", str(csv_copy), "--budget_s", "15", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    summary = json.loads(out.strip().splitlines()[-1])
    assert [s for s, _ in seen] == shapes[:2]
    kw = seen[0][1]
    assert (kw["max_candidates"], kw["finalists"], kw["stage1_rounds"], kw["stage2_rounds"],
            kw["save"], kw["acc"], kw["device"]) == (32, 8, 4, 12, "improve", "float32", "cpu")
    assert [r["kind"] for r in summary["retuned"]] == ["wide", "sentinel"]
    assert summary["retuned"][0]["gain_vs_stored"] == float("inf")
    assert summary["retuned"][0]["fastest_kernel"].startswith("wide 128x2048 bk=64")
    assert summary["retuned"][0]["kernel_vs_torch_matmul"] == pytest.approx(0.9)
    assert summary["retuned"][1]["gain_vs_stored"] == pytest.approx(2.0)
    assert summary["left"] == ["4096x4096x128"] and summary["dropped"] == 2
    assert "4096,4096,128" in err and "vs torch.matmul" in err and "infx vs stored" in err
    assert csv_copy.read_text() == "mnk,torch.matmul\n4096x4096x128,0.5\n"


def test_retune_dry_run_tunes_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(search, "tune_shape", lambda *a, **kw: pytest.fail("tuned"))
    copy = tmp_path / "db.json"
    assert retune.main(["--targets", str(_targets(tmp_path, [(4096, 4096, 64)] * 3)), "--db",
                        str(copy), "--dry_run"]) == 0
    assert json.loads(capsys.readouterr().out.strip())["targets"] == 3
    assert not copy.exists()


# ---- the wide blocks ----

@pytest.mark.parametrize("bm,bn", [(64, 256), (128, 2048), (256, 128), (2048, 16384),
                                   (384, 1280)])
def test_wide_blocks_validate_within_their_shared_memory(bm, bn):
    for bk in (64, 256, 512, 1024, 1280, 1344, 16384):
        cfg = KernelConfig(bm=bm, bn=bn, bk=bk)
        stages, streamed = wide_stages(bm, bk), wide_streamed(bm, bk)
        # every K fits in one mode: A resident where it leaves two ring stages, else A
        # streamed through the ring
        assert stages >= WIDE_MIN_STAGES and cfg.validate() is None
        assert cfg.smem_bytes() == wide_smem_bytes(bm, bk, stages, streamed)
        assert cfg.smem_bytes() <= SMEM_LIMIT
    # a 128-row strip holds K <= 512 resident, a 64-row one K <= 1280; beyond, A streams
    assert not wide_streamed(bm, 512) and not wide_streamed(bm, 1280 if bm == 64 else 512)
    assert wide_streamed(bm, 576) == (bm != 64) and wide_streamed(bm, 1344)


@pytest.mark.parametrize("kw,needle", [
    (dict(bm=32, bn=256), "bm=32"),
    (dict(bm=192, bn=256), "bm=192"),
    (dict(bm=16, bn=256), "bm=16"),
    (dict(bm=256, bn=64), "bn=64"),
    (dict(bm=128, bn=32768), "bn=32768"),
    (dict(bm=256, bn=256, pipeline_depth=2), "pipeline_depth"),
    (dict(bm=32768, bn=256, bk=1024), "bm=32768"),
])
def test_validate_rejects_wide_blocks_it_cannot_build(kw, needle):
    err = KernelConfig(**{"bk": 64, **kw}).validate()
    assert err is not None and needle in err


def _01(seed, m, n, k):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (m, k)).astype(np.float32),
            rng.integers(0, 2, (k, n)).astype(np.float32))


def test_wide_block_launches_only_at_one_interval_on_tma_operands():
    """gk > 1, K or N off 8, a base off 16 bytes, out= off 16 bytes and the batched kernel
    each launch: the K carry on the wide route, and the loads producer ('wgmma_wide_lsu')
    where TMA cannot read an operand or write C; each equals the plain version at the
    config's bk (here, on the CPU, it is that version)."""
    cfg = KernelConfig(bm=256, bn=512, bk=64)
    a_np, b_np = _01(0, 300, 1024, 64)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    assert mm.launch_route(cfg, a, b, 300, 1024, 64) == "wgmma_wide"
    assert torch.equal(mm.cuda_matmul(a, b, cfg, out_dtype=torch.float32),
                       torch.from_numpy(a_np @ b_np))
    cases = [
        (dict(bk=32), (300, 1024, 64), "wgmma_wide"),
        (dict(), (300, 1024, 60), "wgmma_wide_lsu"),
        (dict(bk=128), (300, 1020, 128), "wgmma_wide_lsu"),
    ]
    for change, (m, n, k), route in cases:
        c = dataclasses.replace(cfg, **change)
        x_np, y_np = _01(1, m, n, k)
        x, y = torch.from_numpy(x_np).bfloat16(), torch.from_numpy(y_np).bfloat16()
        assert mm.launch_route(c, x, y, m, n, k) == route
        want = mm.matmul_reference(x, y, c.bk, out_dtype=torch.float32)
        assert torch.equal(want, torch.from_numpy(x_np @ y_np))
        assert torch.equal(mm.cuda_matmul(x, y, c, out_dtype=torch.float32), want)
        assert torch.equal(dispatch.matmul(x, y, config=c, out_dtype=torch.float32), want)
    off = torch.zeros(300 * 64 + 1, dtype=torch.bfloat16)[1:].view(300, 64)
    off.copy_(a)
    assert mm.launch_route(cfg, off, b, 300, 1024, 64) == "wgmma_wide_lsu"
    assert torch.equal(mm.cuda_matmul(off, b, cfg, out_dtype=torch.float32),
                       torch.from_numpy(a_np @ b_np))
    out = torch.zeros(300 * 1024 + 1, dtype=torch.float32)[1:].view(300, 1024)
    assert mm.launch_route(cfg, a, b, 300, 1024, 64, out) == "wgmma_wide_lsu"
    mm.cuda_matmul(a, b, cfg, out=out)
    assert torch.equal(out, torch.from_numpy(a_np @ b_np))
    want = torch.from_numpy(a_np @ b_np)[None].expand(2, -1, -1)
    assert torch.equal(batched.cuda_batched_matmul(
        torch.stack([a, a]), torch.stack([b, b]), cfg, out_dtype=torch.float32), want)
    assert torch.equal(dispatch.batched_matmul(torch.stack([a, a]), torch.stack([b, b]),
                                               config=cfg, out_dtype=torch.float32), want)


@pytest.mark.parametrize("m,n,k", [(16384, 16384, 64), (8192, 8192, 256), (4096, 16384, 512),
                                   (2048, 16384, 128), (4096, 4096, 64)])
def test_candidates_keep_wide_blocks_in_the_band(m, n, k):
    """The band's large shapes keep wide blocks within the retune's 32 candidates, each
    at a bk of the candidate set (a K carry where bk < K); the K step of the set and the
    JAX space's bks alike, nothing staged."""
    cands = candidate_configs(m, n, k, "float32", max_candidates=32)
    wide = [c for c in cands if not c.use_vendor and c.wide]
    assert len(wide) >= 8
    bks = {c for c in (128, 256, 512, 1024, 2048, 4096, 8192, 16384) if c <= round_up(k, 128)}
    for c in wide:
        assert c.validate() is None and c.pipeline_depth == 0
        assert c.bk in bks | {round_up(k, KSTEP)}
    # where K or N is off 8, or K past a resident strip, wide blocks of every height stay
    # (the loads producer, a streamed A), carried ones among them
    for shape in ((16384, 16384, 60), (16384, 16380, 64), (16384, 16384, 1024)):
        big = [c for c in candidate_configs(*shape, max_candidates=10000)
               if not c.use_vendor and c.wide]
        assert {c.bm for c in big} >= {64, 128, 256, 512, 1024, 2048}
        assert all(c.validate() is None for c in big)
    assert any(c.bk < 1024 for c in candidate_configs(16384, 16384, 1024, max_candidates=10000)
               if c.wide)


def test_neighbour_transfer_never_hands_a_wide_block_to_a_shape_it_cannot_launch(
        tmp_path, monkeypatch):
    """Every shape can launch a carried wide block now (a K carry, the loads producer): it
    carries over to them all, dispatch keeps it, and the batched entry point runs the
    kernel at a resolved wide config, as JAX's does."""
    wide = KernelConfig(bm=128, bn=2048, bk=64)
    src = (16384, 16384, 64)
    # where TMA reads it, and where K or N is off 8 (the loads producer)
    assert _adapt(wide, src, (16384, 8192, 64)) == wide
    assert _adapt(wide, src, (16384, 16384, 60)) == wide
    assert _adapt(wide, src, (16384, 16380, 64)) == wide
    # a K carry: the source's bk is not its whole K, so it stays bk 64 at K = 96
    carried = KernelConfig(bm=128, bn=2048, bk=64)
    assert _adapt(carried, (16384, 16384, 128), (16384, 16384, 96)) == carried
    # through the DB: dispatch keeps it, the seeds hand it on
    path = tmp_path / "db.json"
    db = db_mod.TuneDB(path=path)
    db.put(*src, wide, 300.0, acc="float32", extra={"speedup_vs_torch_matmul": 1.5})
    db.save()
    monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    db_mod.reset_default_db()
    try:
        assert dispatch.resolve_config(*src) == wide
        assert dispatch.resolve_config(16384, 8192, 64) == wide
        for shape in ((16384, 16384, 60), (16384, 16380, 64)):
            assert dispatch.resolve_config(*shape) == wide
            assert wide in neighbor_seed_configs(db_mod.default_db(), *shape)
        # the batched entry point runs the kernel at its resolved wide config: here the
        # plain version at that config's bk, whose bf16 carry rounds where the sentinel's
        # f32 sum does not
        rng = np.random.default_rng(3)
        a = torch.from_numpy(rng.standard_normal((2, 64, 512), np.float32)).bfloat16()
        b = torch.from_numpy(rng.standard_normal((2, 512, 2048), np.float32)).bfloat16()
        carry = KernelConfig(bm=64, bn=2048, bk=128, acc_dtype="bfloat16")
        db.put(64, 2048, 512, carry, 1.0, acc="bfloat16")
        db.save()
        db_mod.reset_default_db()
        got = dispatch.batched_matmul(a, b, acc="bfloat16", out_dtype=torch.float32)
        want = batched.batched_matmul_reference(a, b, 128, "bfloat16", torch.float32)
        assert torch.equal(got, want)
        assert not torch.equal(got, a.float() @ b.float())
    finally:
        db_mod.reset_default_db()


#: The JAX DB's kernel entries that launch at their own shape after from_jax: before the
#: wide blocks (edges up to 128 only) and after (every entry but the two bm = 16 ones).
JAX_DB_LAUNCHABLE = {"before": 11, "after": 212}


def test_from_jax_carries_the_jax_dbs_wide_single_k_entries():
    entries = json.loads((REPO / "tpul2" / "data" / "tunedb_v5e.json").read_text())["entries"]
    before = after = kernels = 0
    for key, entry in entries.items():
        if entry["config"].get("use_xla"):
            continue
        kernels += 1
        m, n, k = map(int, key.split("/")[0].split("_"))
        cfg = KernelConfig.from_jax(entry["config"])
        valid = cfg.validate() is None
        before += valid and cfg.bm in TILE_CHOICES and cfg.bn in TILE_CHOICES
        after += valid
    assert kernels == 214
    assert {"before": before, "after": after} == JAX_DB_LAUNCHABLE


def test_parity_with_pallas_at_a_wide_whole_k_block():
    """tpul2's pallas_matmul (interpret mode) at bm 64, bn 512, bk = K against the port at
    from_jax of the same config: 0/1 inputs, diff == 0."""
    jax_cfg = jcfg.KernelConfig(bm=64, bn=512, bk=64)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    assert cfg.wide and cfg.validate() is None
    a_np, b_np = _01(7, 128, 1024, 64)
    theirs = pallas_matmul(jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16),
                           jax_cfg, out_dtype=jnp.float32)
    ours = mm.cuda_matmul(torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16(),
                          cfg, out_dtype=torch.float32)
    assert float((ours - torch.from_numpy(np.array(theirs, np.float32))).abs().max()) == 0.0

