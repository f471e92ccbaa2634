"""``python -m tpul2_torch.harness`` on the CPU: every subcommand at a small shape with
``--device cpu``, each printing one JSON object, and the subcommands and flags held
against the JAX CLI's through the ``--help`` texts (no JAX subcommand is run)."""

import json
import re

import pytest
import torch

from tpul2.harness import __main__ as jax_cli
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.harness import __main__ as cli

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

SHAPE = ["--mnk", "96", "160", "200"]
SUBCOMMANDS = ["correctness", "offline", "server", "summarize", "defend", "profile"]


@pytest.fixture(autouse=True)
def empty_tunedb(tmp_path, monkeypatch):
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty_tunedb.json"))
    db_mod.reset_default_db()
    yield
    db_mod.reset_default_db()


def _help(main, argv, capsys) -> str:
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 0
    return capsys.readouterr().out


def _flags(text: str) -> set:
    return set(re.findall(r"(--[a-z_]+)", text)) - {"--help"}


def test_subcommands_match_the_jax_cli(capsys):
    ours = _help(cli.main, ["--help"], capsys)
    theirs = _help(jax_cli.main, ["--help"], capsys)
    pattern = r"\{([a-z,]+)\}"
    assert re.search(pattern, ours).group(1).split(",") == SUBCOMMANDS
    assert re.search(pattern, theirs).group(1).split(",") == SUBCOMMANDS


@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_flags_match_the_jax_cli(capsys, sub):
    ours = _flags(_help(cli.main, [sub, "--help"], capsys))
    theirs = _flags(_help(jax_cli.main, [sub, "--help"], capsys))
    assert ours - theirs == ({"--device"} if "--mnk" in theirs else set())
    assert theirs <= ours


def _run(capsys, argv) -> tuple:
    rc = cli.main(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_every_subcommand_on_the_cpu(capsys, tmp_path):
    base = str(tmp_path / "out")
    rc, res = _run(capsys, ["correctness", *SHAPE, "--iterations", "2", "--seconds", "10",
                            "--device", "cpu"])
    assert rc == 0 and res["pass"] and res["device"] == "cpu"
    bench = ["--warmup_seconds", "0", "--benchmark_seconds", "0.05", "--device", "cpu"]
    rc, res = _run(capsys, ["offline", *SHAPE, "--perf_func", "torch_matmul", *bench,
                            "--base_dir", base])
    assert rc == 0 and res["perf_func"] == "torch_matmul" and res["mode"] == "offline"
    rc, res = _run(capsys, ["server", *SHAPE, "--perf_func", "cublas_tn", "--target_qps",
                            "1000", *bench, "--base_dir", base + "_server"])
    assert rc == 0 and res["mode"] == "server" and res["target_qps"] == 1000.0
    rc, res = _run(capsys, ["summarize", "--base_dir", base])
    assert rc == 0 and res["markdown"].startswith("### offline")
    assert "| torch.matmul |" in res["markdown"]
    rc, res = _run(capsys, ["defend", *SHAPE, "--acc", "bfloat16", "--device", "cpu"])
    assert rc == 0 and res["pass"] and len(res["defenses"]) == 5
    rc, res = _run(capsys, ["profile", *SHAPE, "--trials", "2", "--device", "cpu"])
    assert rc == 0 and res["mnk"] == [96, 160, 200] and res["device"] == "cpu"


@pytest.mark.parametrize("sub", ["correctness", "offline", "defend", "profile"])
def test_cuda_without_a_card_raises(sub):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    extra = ["--perf_func", "torch_matmul"] if sub == "offline" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([sub, *SHAPE, *extra])
