"""tpul2_torch's integrity defenses on the CPU: each check against an honest function and a
cheating one, and the verdicts held against the JAX package's defenses where the threat
exists in both (thread injection, precision downgrade, monkey-patching).

The stream-injection cheat needs a second CUDA stream; it is in ``test_torch_gpu.py``.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpul2.harness import defense as jax_defense
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.dispatch import candidate_fn
from tpul2_torch.harness import defense
from tpul2_torch.harness.bench_utils import fresh_inputs

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

M, N, K = 96, 160, 200


@pytest.fixture(autouse=True)
def empty_tunedb(tmp_path, monkeypatch):
    """The candidate resolves through the heuristic (plain versions on the CPU)."""
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty_tunedb.json"))
    db_mod.reset_default_db()
    yield
    db_mod.reset_default_db()


@pytest.fixture
def release():
    """An event that the helper threads of the thread cheats wait on, set at teardown."""
    ev = threading.Event()
    yield ev
    ev.set()


def _args():
    return fresh_inputs(np.random.default_rng(0), M, N, K, device="cpu")


def _jax_args():
    a, b, b_t = _args()
    return tuple(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (a, b, b_t))


def _honest(a, b, b_t):
    return torch.matmul(a, b)


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_honest_candidate_passes_every_defense(acc):
    res = defense.run_all_defenses(candidate_fn(acc), _args())
    assert res["pass"], res
    assert [d["name"] for d in res["defenses"]] == list(defense.NAMES)
    stream = res["defenses"][2]
    assert stream["clock"] == "host" and stream["runs_flagged"] == 0
    assert len(stream["runs"]) == defense.STREAM_RUNS


def test_thread_injection_flags_a_leaking_function(release):
    def leak(a, b, b_t):
        threading.Thread(target=release.wait, daemon=True).start()
        return torch.matmul(a, b)

    args = _args()
    assert defense.defend_against_thread_injection(_honest, args)["pass"]
    res = defense.defend_against_thread_injection(leak, args)
    assert not res["pass"] and res["threads_after"] > res["threads_before"]
    assert not defense.run_all_defenses(leak, args)["pass"]


class _Lazy(torch.Tensor):
    pass


@pytest.mark.parametrize("cheat", ["subclass", "meta", "wrong_shape", "not_a_tensor"])
def test_lazy_evaluation_flags(cheat):
    def fn(a, b, b_t):
        out = torch.matmul(a, b)
        if cheat == "subclass":
            return out.as_subclass(_Lazy)
        if cheat == "meta":
            return torch.empty(out.shape, dtype=out.dtype, device="meta")
        if cheat == "wrong_shape":
            return out.t()
        return out.float().numpy()  # not a tensor

    args = _args()
    assert defense.defend_against_lazy_evaluation(_honest, args, (M, N))["pass"]
    res = defense.defend_against_lazy_evaluation(fn, args, (M, N))
    assert not res["pass"], res
    assert not defense.run_all_defenses(fn, args)["pass"]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_precision_downgrade_flags(dtype):
    args = _args()
    assert defense.defend_against_precision_downgrade(_honest, args, torch.bfloat16)["pass"]
    res = defense.defend_against_precision_downgrade(
        lambda a, b, b_t: torch.matmul(a, b).to(dtype), args, torch.bfloat16)
    assert not res["pass"] and res["actual"] == str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("target", ["time.perf_counter", "time.sleep",
                                    "torch.cuda.synchronize", "torch.cuda.Event.record",
                                    "torch.cuda.Event.elapsed_time"])
def test_monkey_patching_flags(monkeypatch, target):
    assert defense.defend_against_monkey_patching()["pass"]
    owner, attr = target.rsplit(".", 1)
    obj = {"time": time, "torch.cuda": torch.cuda, "torch.cuda.Event": torch.cuda.Event}[owner]
    monkeypatch.setattr(obj, attr, lambda *a, **kw: 0.0)
    res = defense.defend_against_monkey_patching()
    assert not res["pass"] and res[target] is False
    assert sum(not v for k, v in res.items() if k not in ("name", "pass")) == 1
    # the defenses time with the originals, so a patched clock cannot fool them
    assert defense.run_all_defenses(_honest, _args(),
                                    which=("stream_injection",))["pass"]


def test_run_all_defenses_contract():
    args = _args()
    res = defense.run_all_defenses(_honest, args, which=("precision_downgrade",))
    assert res["defenses"][0]["expected"] == "bfloat16"  # the operands' dtype by default
    res = defense.run_all_defenses(_honest, args, expected_shape=(N, M),
                                   which=("lazy_evaluation",))
    assert not res["pass"]
    with pytest.raises(ValueError, match="unknown defense"):
        defense.run_all_defenses(_honest, args, which=("async_cheating",))


# --- the verdict table against the JAX package's defenses ---

def _scenarios_thread(release):
    def leak_torch(a, b, b_t):
        threading.Thread(target=release.wait, daemon=True).start()
        return torch.matmul(a, b)

    def leak_jax(a, b, b_t):
        threading.Thread(target=release.wait, daemon=True).start()
        return jnp.matmul(a, b)

    return {"honest": (_honest, lambda a, b, b_t: jnp.matmul(a, b)),
            "leak": (leak_torch, leak_jax)}


def test_thread_verdicts_match_jax(release):
    table = {}
    for name, (fn_t, fn_j) in _scenarios_thread(release).items():
        ours = defense.defend_against_thread_injection(fn_t, _args())["pass"]
        theirs = jax_defense.defend_against_thread_injection(fn_j, _jax_args(),
                                                             settle_s=0.1)["pass"]
        table[name] = (ours, theirs)
    assert table == {"honest": (True, True), "leak": (False, False)}


@pytest.mark.parametrize("out", ["bfloat16", "float16", "float32"])
def test_precision_verdicts_match_jax(out):
    ours = defense.defend_against_precision_downgrade(
        lambda a, b, b_t: torch.matmul(a, b).to(getattr(torch, out)), _args(),
        torch.bfloat16)["pass"]
    theirs = jax_defense.defend_against_precision_downgrade(
        lambda a, b, b_t: jnp.matmul(a, b).astype(getattr(jnp, out)), _jax_args(),
        jnp.bfloat16)["pass"]
    assert ours == theirs == (out == "bfloat16")


@pytest.mark.parametrize("target", [None, "perf_counter", "sleep"])
def test_monkey_patching_verdicts_match_jax(monkeypatch, target):
    if target is not None:
        monkeypatch.setattr(time, target, lambda *a, **kw: 0.0)
    ours = defense.defend_against_monkey_patching()["pass"]
    theirs = jax_defense.defend_against_monkey_patching()["pass"]
    assert ours == theirs == (target is None)
