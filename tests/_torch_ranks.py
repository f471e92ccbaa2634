"""Rank processes of tests/test_torch_parallel.py: one process per rank of a gloo group on
the CPU, each running the port's parallel layer on its blocks and writing its results as
.npy / .json files into the job directory.

This module imports neither jax nor the tpul2 package: spawned children import it anew,
and tests/conftest.py, which a test module's import would pull in, forces an 8-device JAX
backend.  The parent (the test module) writes the inputs and reads the results; the JAX
side runs there.  Rendezvous goes through a file in the job directory, never a TCP port,
so that parallel test workers cannot collide.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import time
import traceback
from pathlib import Path

import numpy as np

#: name -> ((m, n, k), spec of A, spec of B, spec of the output): tests/test_parallel.py's
#: sizes, so that every bf16 sum of its 0/1 inputs stays exact.
STRATEGIES = {
    "dp_matmul": ((64, 128, 128), ("dp", None), (None, None), ("dp", None)),
    "tp_matmul": ((32, 512, 128), (None, None), (None, "tp"), (None, "tp")),
    "kshard_matmul": ((16, 128, 512), (None, "tp"), ("tp", None), (None, None)),
    "sharded_matmul_2d": ((32, 128, 512), ("dp", "tp"), ("tp", None), ("dp", None)),
    "kshard_scatter_matmul": ((32, 512, 512), (None, "tp"), ("tp", None), (None, "tp")),
}
FAMILIES = ("float32", "bfloat16")
#: The DB-dispatched check's operands: A (64, 256), B (256, 256), 0/1 at density 0.2.
DB_SHAPE = (64, 256, 256)
#: The sharded FFN step's widths (tests/test_parallel.py's), its lr for the update check,
#: and the lr and step count of the learning check.
D_MODEL, D_FF, BATCH = 128, 512, 32
LR = 1.0
LEARN_LR, LEARN_STEPS = 1e-2, 5
#: The explicit config of the strategies and the step (tile and bk of the JAX tests'
#: KernelConfig(bm=16, bn=128, bk=128) with the port's least tile edge).
TILE = dict(bm=32, bn=128, bk=128)


def data(m: int, n: int, k: int, seed: int = 0) -> tuple:
    """0/1 operands (as f32) and their exact product, tests/test_parallel.py's ``_data``."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (m, k)).astype(np.float32)
    b = rng.integers(0, 2, (k, n)).astype(np.float32)
    return a, b, a @ b


def _save(job: Path, name: str, rank: int, t) -> None:
    np.save(job / f"{name}.r{rank}.npy", t.detach().float().numpy())


def _rank(rank: int, world: int, job: Path) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["TPUL2_TORCH_TUNEDB"] = str(job / "db.json")
    from tpul2_torch import parallel as par
    from tpul2_torch.config import KernelConfig
    from tpul2_torch.dispatch import resolve_config
    from tpul2_torch.models import FFNParams, make_sharded_train_step

    def bf16(x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)

    dist.init_process_group("gloo", init_method=f"file://{job / 'rendezvous'}",
                            rank=rank, world_size=world)
    try:
        mesh = par.make_mesh(world, device_type="cpu")
        info = {"coord": list(mesh.get_coordinate()), "shape": list(mesh.shape),
                "names": list(mesh.mesh_dim_names),
                "shape_1d": list(par.make_mesh(world, ("tp",), device_type="cpu").shape)}
        for bad, args in (("too_many", (world + 1,)), ("three_axes", (world, ("a", "b", "c")))):
            try:
                par.make_mesh(*args, device_type="cpu")
                info[bad] = "no error"
            except ValueError as e:
                info[bad] = f"ValueError: {e}"

        # the five strategies on explicit configs, both families
        inputs = np.load(job / "inputs.npz")
        for name, (_, sa, sb, _) in STRATEGIES.items():
            fn = getattr(par, name)
            a = par.shard_array(bf16(inputs[f"{name}.a"]), mesh, sa)
            b = par.shard_array(bf16(inputs[f"{name}.b"]), mesh, sb)
            for acc in FAMILIES:
                cfg = KernelConfig(**TILE, acc_dtype=acc)
                _save(job, f"{name}.{acc}", rank, fn(a, b, mesh, acc=acc, config=cfg))

        # the same through the DB (config=None): kernel, sentinel and staged entries
        db_in = np.load(job / "db_inputs.npz")
        resolved = {}
        for name, (_, sa, sb, _) in STRATEGIES.items():
            a = par.shard_array(bf16(db_in["a"]), mesh, sa)
            b = par.shard_array(bf16(db_in["b"]), mesh, sb)
            for acc in FAMILIES:
                m, k = a.shape
                resolved[f"{name}.{acc}"] = dataclasses.asdict(
                    resolve_config(m, b.shape[1], k, acc))
                _save(job, f"db.{name}.{acc}", rank,
                      getattr(par, name)(a, b, mesh, acc=acc, config=None))
        info["resolved"] = resolved

        # the sharded FFN step
        ffn = np.load(job / "ffn.npz")
        params = FFNParams(bf16(ffn["w1"]), bf16(ffn["w2"]))
        cfg = KernelConfig(**TILE)
        step0, shard = make_sharded_train_step(mesh, lr=0.0, config=cfg)
        w1, w2, x, y = shard(params, bf16(ffn["x"]), bf16(ffn["y"]))
        info["loss_lr0"] = float(step0(w1, w2, x, y)[2])
        step, _ = make_sharded_train_step(mesh, lr=LR, config=cfg)
        n1, n2, _ = step(w1, w2, x, y)
        _save(job, "step.w1", rank, n1)
        _save(job, "step.w2", rank, n2)
        learn, _ = make_sharded_train_step(mesh, lr=LEARN_LR, config=cfg)
        losses = []
        for _ in range(LEARN_STEPS):
            w1, w2, loss = learn(w1, w2, x, y)
            losses.append(float(loss))
        info["losses"] = losses
        (job / f"info.r{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


def _main(rank: int, world: int, job_dir: str) -> None:
    job = Path(job_dir)
    try:
        _rank(rank, world, job)
    except BaseException:
        (job / f"error.r{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn(world: int, job_dir: Path, timeout: float = 120.0) -> None:
    """Run ``world`` rank processes on the job directory's inputs; raise, with each failed
    rank's traceback, if one fails or the group outlasts ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(r, world, str(job_dir))) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join(10)
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if hung or failed:
        errors = "\n".join((Path(job_dir) / f"error.r{r}.txt").read_text()
                           for r in failed if (Path(job_dir) / f"error.r{r}.txt").exists())
        raise RuntimeError(f"ranks hung past {timeout} s: {hung}; exit codes {failed}\n"
                           f"{errors}")
