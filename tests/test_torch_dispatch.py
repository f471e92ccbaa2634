"""tpul2_torch.dispatch against ``tpul2.matmul``: the whole slice on shared inputs.

On 0/1 inputs the f32 family is exact and independent of tiling, so the port's
resolved config and the JAX package's (its TuneDB or heuristic) must give identical
results.  With one config dict for both sides (``KernelConfig.from_jax``) the bf16 family
is exact on 0/1 inputs too.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2
import tpul2.config as jcfg
from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import KernelConfig
from tpul2_torch.ops.baselines import BASELINES, VENDOR_VARIANTS

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def empty_tunedb(tmp_path, monkeypatch):
    """These tests hold the heuristic: TPUL2_TORCH_TUNEDB names a file that is not there,
    so no DB, the committed one included, steers their resolution."""
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty_tunedb.json"))
    db_mod.reset_default_db()
    yield
    db_mod.reset_default_db()


def _01(seed, m, n, k):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (m, k)).astype(np.float32),
            rng.integers(0, 2, (k, n)).astype(np.float32))


def _jax_out(a_np, b_np, **kw):
    out = tpul2.matmul(jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16), **kw)
    return torch.from_numpy(np.array(out, np.float32))


@pytest.mark.parametrize("m,n,k", [(96, 160, 200), (128, 256, 512), (64, 128, 64),
                                   (33, 130, 257)])
def test_slice_matches_jax_f32_family(m, n, k):
    a_np, b_np = _01(11, m, n, k)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    ours = dispatch.matmul(a, b, out_dtype=torch.float32)
    assert torch.equal(ours, _jax_out(a_np, b_np, out_dtype=jnp.float32))
    # default output dtype is the input's, as in the JAX package
    assert dispatch.matmul(a, b).dtype == torch.bfloat16


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_slice_with_shared_config(acc, layout):
    m, n, k = 96, 256, 384
    d = dict(bm=32, bn=128, bk=128, acc_dtype=acc, rhs_layout=layout, edge="mask")
    jax_cfg = jcfg.KernelConfig(**d)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    a_np, b_np = _01(12, m, n, k)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    ours = dispatch.matmul(a, b, acc=acc, config=cfg, b_t=b.t().contiguous())
    theirs = _jax_out(a_np, b_np, acc=acc, config=jax_cfg)
    assert torch.equal(ours.float(), theirs)


def test_candidate_entries_keep_the_harness_abi():
    a_np, b_np = _01(13, 64, 96, 160)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    b_t = b.t().contiguous()
    truth = torch.from_numpy(a_np @ b_np)
    for acc, fn in (("float32", dispatch.cuda_l2_h100_f32),
                    ("bfloat16", dispatch.cuda_l2_h100_bf16)):
        assert dispatch.candidate_fn(acc) is fn
        assert torch.equal(fn(a, b, b_t).float(), truth)
        out = torch.empty((64, 96), dtype=torch.float32)
        assert fn(a, b, b_t, out=out) is out and torch.equal(out, truth)


@pytest.mark.parametrize("variant", VENDOR_VARIANTS)
def test_vendor_sentinel(variant):
    a_np, b_np = _01(14, 48, 80, 96)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    bias = torch.linspace(-2, 2, 80)
    out = dispatch.matmul(a, b, config=KernelConfig.vendor(variant), bias=bias,
                          activation="relu", out_dtype=torch.float32)
    assert torch.equal(out, torch.relu(torch.from_numpy(a_np @ b_np) + bias))


@pytest.mark.parametrize("variant", VENDOR_VARIANTS)
def test_vendor_sentinel_delivers_the_f32_sum(variant):
    """Sums above 256 are not exact in bf16: an f32 output through the sentinel must be
    the f32 sum, as the JAX package's sentinel (its XLA_VARIANT_FNS) delivers it."""
    a_np, b_np = _01(16, 32, 48, 2048)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    truth = torch.from_numpy(a_np @ b_np)
    assert truth.max() > 256
    cfg = KernelConfig.vendor(variant)
    assert torch.equal(dispatch.matmul(a, b, config=cfg, out_dtype=torch.float32), truth)
    theirs = _jax_out(a_np, b_np, out_dtype=jnp.float32, config=jcfg.KernelConfig.xla(
        "dot_tn" if variant.endswith("_tn") else "dot_nn"))
    assert torch.equal(theirs, truth)
    bias = torch.full((48,), 0.5)
    assert torch.equal(dispatch.matmul(a, b, config=cfg, bias=bias, out_dtype=torch.float32),
                       truth + 0.5)
    batched = dispatch.batched_matmul(a[None], b[None], config=cfg, out_dtype=torch.float32)
    assert torch.equal(batched[0], truth)


def test_baselines_return_the_input_dtype():
    a_np, b_np = _01(15, 32, 48, 64)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    for fn in BASELINES.values():
        out = fn(a, b, b.t().contiguous())
        assert out.dtype == torch.bfloat16
        assert torch.equal(out.float(), torch.from_numpy(a_np @ b_np))


@pytest.mark.parametrize("m,n,k", [(4096, 4096, 4096), (64, 8192, 8192), (8192, 128, 64),
                                   (1000, 1000, 1000)])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_resolve_never_returns_the_sentinel(m, n, k, acc):
    cfg = dispatch.resolve_config(m, n, k, acc)
    assert not cfg.use_vendor and cfg.validate() is None


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        dispatch.matmul(torch.zeros((4, 5)).bfloat16(), torch.zeros((6, 7)).bfloat16())
    with pytest.raises(ValueError):
        dispatch.batched_matmul(torch.zeros((2, 4, 5)).bfloat16(),
                                torch.zeros((2, 6, 7)).bfloat16())


def test_port_imports_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import tpul2_torch, "
            "tpul2_torch.dispatch, tpul2_torch.ops.matmul, tpul2_torch.ops.batched, "
            "tpul2_torch.ops.pipelined, tpul2_torch.ops._build, "
            "tpul2_torch.harness.correctness, tpul2_torch.harness.bench_server, "
            "tpul2_torch.harness.bench_offline, tpul2_torch.harness.summarize, "
            "tpul2_torch.harness.suite, tpul2_torch.ops.lt_autotune, "
            "tpul2_torch.autotune, tpul2_torch.autotune.db, tpul2_torch.autotune.search, "
            "tpul2_torch.autotune.transfer, tpul2_torch.autotune.__main__, "
            "tpul2_torch.utils.platform, tpul2_torch.native, tpul2_torch.parallel, "
            "tpul2_torch.models; print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"


def test_port_sources_name_no_jax():
    scripts = sorted((REPO / "scripts").glob("*_torch.py"))
    for name in ("eval_one_shape", "run_suite", "seed_tail_entries", "correctness_campaign"):
        assert REPO / "scripts" / f"{name}_torch.py" in scripts
    for path in list((REPO / "tpul2_torch").rglob("*.py")) + scripts + [
            REPO / "chip_smoke.py", REPO / "tests" / "_torch_ranks.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from tpul2." not in text and "import tpul2\n" not in text, path
