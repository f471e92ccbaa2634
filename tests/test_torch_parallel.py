"""tpul2_torch.parallel and the sharded FFN step against tpul2.parallel on the CPU.

The port runs in gloo groups of 2 and 4 rank processes (tests/_torch_ranks.py: one spawn
per world size runs every check and writes its results into a job directory); the JAX
package runs here on its 8-device CPU mesh, as ``make_mesh(2)`` (1 x 2) and
``make_mesh(4)`` (2 x 2), the port's ``make_mesh`` giving the same shapes.  Inputs are
drawn once with numpy and handed to both.

Tolerances, each with its reason:
  strategies     exact: 0/1 inputs at tests/test_parallel.py's sizes keep every sum,
                 bf16 ones included, an integer the types hold exactly;
  loss at lr 0   rtol 2e-2, JAX's own test_sharded_matches_single_device's;
  weight update  relative L2 distance of the sharded step's update (new - old weights,
                 one step at lr 1.0) from the single-device step's <= UPDATE_TOL = 0.1.
                 The new weights are bf16, so an update is quantized to the weights' ulp,
                 and a small difference in the gradient flips the rounding of the
                 elements near a rounding point.  The sharded step's gradient differs by
                 more than reordered sums: its FFN-2 output stays f32 into the loss (the
                 JAX sharded step's layout), where train_step's ffn_forward rounds it to
                 bf16.  Measured here: 0.020-0.023 (W1) and 0.007-0.009 (W2) at worlds 2
                 and 4, against 0.0034 between the port's and JAX's single-device steps
                 (at lr 0.1, with more elements below one ulp, 0.046-0.071).  An update
                 scaled by tp (the JAX sharded step's, see
                 test_update_check_tells_a_tp_scaled_update_apart) is off by >= 1.0.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from tpul2 import config as jcfg
from tpul2 import parallel as jpar
from tpul2.models import mlp as jmlp
from tpul2.parallel.sharded_matmul import shard_array as jshard
from tpul2_torch.autotune.db import TuneDB
from tpul2_torch.config import KernelConfig
from tpul2_torch.models import ffn_params_from_numpy, train_step
from tpul2_torch.parallel.mesh import _factor

P = jax.sharding.PartitionSpec
JCFG = jcfg.KernelConfig(bm=16, bn=128, bk=128)
UPDATE_TOL = 0.1
RANK_TIMEOUT = 120.0


def _bf16_f32(x) -> np.ndarray:
    """x rounded to bf16 (as JAX rounds it), held in f32 (exact)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _ffn_inputs() -> dict:
    """tests/test_parallel.py's sharded-step inputs: He-normal weights, normal x and y."""
    rng = np.random.default_rng(0)
    d, f, b = ranks.D_MODEL, ranks.D_FF, ranks.BATCH
    return {"w1": _bf16_f32(rng.standard_normal((d, f)) * (2.0 / d) ** 0.5),
            "w2": _bf16_f32(rng.standard_normal((f, d)) * (2.0 / f) ** 0.5),
            "x": _bf16_f32(rng.standard_normal((b, d))),
            "y": _bf16_f32(rng.standard_normal((b, d)))}


def _db_inputs() -> dict:
    rng = np.random.default_rng(3)
    m, n, k = ranks.DB_SHAPE
    return {"a": (rng.random((m, k)) < 0.2).astype(np.float32),
            "b": (rng.random((k, n)) < 0.2).astype(np.float32)}


def _db_entries(world: int) -> dict:
    """(m, n, k) -> config kind of the DB-dispatched check's local shapes: a kernel entry
    under the K-sharded strategies, a sentinel under dp, a staged ring under tp."""
    dp, tp = _factor(world)
    m, n, k = ranks.DB_SHAPE
    return {(m, n, k // tp): "kernel", (m // dp, n, k): "sentinel", (m, n // tp, k): "staged"}


def _entry_config(kind: str, acc: str) -> KernelConfig:
    return {"kernel": KernelConfig(bm=32, bn=128, bk=64, acc_dtype=acc),
            "sentinel": KernelConfig.vendor("cublas_nn"),
            "staged": KernelConfig(bm=64, bn=64, bk=64, pipeline_depth=2, acc_dtype=acc)}[kind]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def job(request, tmp_path_factory):
    """(world, job dir, per-rank info): one spawn of ``world`` gloo ranks, every check."""
    world = request.param
    path = tmp_path_factory.mktemp(f"ranks{world}")
    np.savez(path / "inputs.npz", **{f"{name}.{x}": arr
                                     for name, (shape, *_) in ranks.STRATEGIES.items()
                                     for x, arr in zip("ab", ranks.data(*shape)[:2])})
    np.savez(path / "db_inputs.npz", **_db_inputs())
    np.savez(path / "ffn.npz", **_ffn_inputs())
    db = TuneDB(path=path / "db.json")
    for (m, n, k), kind in _db_entries(world).items():
        for acc in ranks.FAMILIES:
            db.put(m, n, k, _entry_config(kind, acc), 1.0, acc=acc)
    db.save()
    ranks.spawn(world, path, timeout=RANK_TIMEOUT)
    infos = [json.loads((path / f"info.r{r}.json").read_text())
             for r in range(world)]
    return world, path, infos


def _blocks(path, name: str, world: int) -> list:
    return [np.load(path / f"{name}.r{r}.npy") for r in range(world)]


def _gather(blocks: list, infos: list, spec, full_shape) -> np.ndarray:
    """The global array from each rank's block under ``spec``; replicated copies must
    agree."""
    full = np.full(full_shape, np.nan, np.float32)
    for block, info in zip(blocks, infos):
        index = []
        for dim, axis in enumerate(spec):
            if axis is None:
                index.append(slice(None))
                continue
            i = info["names"].index(axis)
            size = full_shape[dim] // info["shape"][i]
            index.append(slice(info["coord"][i] * size, (info["coord"][i] + 1) * size))
        index = tuple(index)
        seen = full[index]
        assert np.isnan(seen).all() or np.array_equal(seen, block), "replicas differ"
        full[index] = block
    return full


def test_factor_matches_jax():
    for n in (1, 2, 3, 4, 6, 8, 9, 12, 16, 30):
        assert _factor(n) == jpar.mesh._factor(n), n
    assert jpar.make_mesh(8).devices.shape == _factor(8) == (2, 4)


def test_make_mesh_in_a_gloo_world(job):
    world, _, infos = job
    for info in infos:
        assert tuple(info["shape"]) == jpar.make_mesh(world).devices.shape
        assert info["names"] == ["dp", "tp"]
        assert info["shape_1d"] == [world]
        assert info["too_many"].startswith("ValueError"), info["too_many"]
        assert info["three_axes"].startswith("ValueError"), info["three_axes"]
    assert sorted(tuple(i["coord"]) for i in infos) == sorted(
        np.ndindex(*jpar.make_mesh(world).devices.shape))


@pytest.mark.parametrize("acc", ranks.FAMILIES)
@pytest.mark.parametrize("name", list(ranks.STRATEGIES))
def test_strategy_matches_jax(job, name, acc):
    """Each rank's block equals the JAX output's shard on the device at its coordinate,
    and the gathered result equals JAX's and the truth, exactly."""
    world, path, infos = job
    (m, n, k), sa, sb, so = ranks.STRATEGIES[name]
    a, b, truth = ranks.data(m, n, k)
    mesh = jpar.make_mesh(world)
    ga = jshard(jnp.asarray(a, jnp.bfloat16), mesh, P(*sa))
    gb = jshard(jnp.asarray(b, jnp.bfloat16), mesh, P(*sb))
    cfg = dataclasses.replace(JCFG, acc_dtype=acc)
    out = getattr(jpar, name)(ga, gb, mesh, acc=acc, config=cfg)
    blocks = _blocks(path, f"{name}.{acc}", world)
    for block, info in zip(blocks, infos):
        device = mesh.devices[tuple(info["coord"])]
        shard = next(s for s in out.addressable_shards if s.device == device)
        np.testing.assert_array_equal(block, np.asarray(shard.data, np.float32))
    full = _gather(blocks, infos, so, (m, n))
    np.testing.assert_array_equal(full, np.asarray(out, np.float32))
    np.testing.assert_array_equal(full, truth)


@pytest.mark.parametrize("acc", ranks.FAMILIES)
def test_db_dispatched_strategies_exact(job, acc):
    """config=None: each local product resolves through the pinned DB (a kernel, a
    sentinel and a staged entry at the local shapes), and every strategy stays exact."""
    world, path, infos = job
    ins = _db_inputs()
    truth = ins["a"] @ ins["b"]
    m, n, _ = ranks.DB_SHAPE
    entries = _db_entries(world)
    for name, (_, sa, sb, so) in ranks.STRATEGIES.items():
        full = _gather(_blocks(path, f"db.{name}.{acc}", world), infos, so, (m, n))
        np.testing.assert_array_equal(full, truth, err_msg=f"{name} {acc}")
    dp, tp = _factor(world)
    mm, nn, kk = ranks.DB_SHAPE
    for name, shape in (("kshard_matmul", (mm, nn, kk // tp)), ("dp_matmul", (mm // dp, nn, kk)),
                        ("tp_matmul", (mm, nn // tp, kk))):
        for info in infos:
            got = KernelConfig(**info["resolved"][f"{name}.{acc}"])
            assert got == _entry_config(entries[shape], acc), (name, got)


def test_sharded_loss_matches_jax_at_lr0(job):
    world, _, infos = job
    ffn = _ffn_inputs()
    params = jmlp.FFNParams(jnp.asarray(ffn["w1"], jnp.bfloat16),
                            jnp.asarray(ffn["w2"], jnp.bfloat16))
    mesh = jpar.make_mesh(world)
    step, shard_fn = jmlp.make_sharded_train_step(mesh, lr=0.0, config=JCFG)
    jloss = float(step(*shard_fn(params, jnp.asarray(ffn["x"], jnp.bfloat16),
                                 jnp.asarray(ffn["y"], jnp.bfloat16)))[2])
    for info in infos:
        np.testing.assert_allclose(info["loss_lr0"], jloss, rtol=2e-2)


def _single_updates() -> dict:
    """name -> (W1 update, W2 update) of one single-device step at ranks.LR: the port's
    train_step (plain versions) and the JAX package's (interpret mode)."""
    ffn = _ffn_inputs()
    jparams = jmlp.FFNParams(jnp.asarray(ffn["w1"], jnp.bfloat16),
                             jnp.asarray(ffn["w2"], jnp.bfloat16))
    jx, jy = (jnp.asarray(ffn[v], jnp.bfloat16) for v in "xy")
    params = ffn_params_from_numpy({k: np.asarray(v) for k, v in jparams._asdict().items()},
                                   device="cpu")
    x, y = (torch.from_numpy(ffn[v]).to(torch.bfloat16) for v in "xy")
    new, _ = train_step(params, x, y, lr=ranks.LR, config=KernelConfig(**ranks.TILE))
    port = tuple(t.float().numpy() - ffn[w] for t, w in zip(new, ("w1", "w2")))
    jnew, _ = jmlp.train_step(jparams, jx, jy, lr=ranks.LR, config=JCFG)
    jax_single = tuple(np.asarray(t, np.float32) - ffn[w] for t, w in zip(jnew, ("w1", "w2")))
    return {"port": port, "jax": jax_single}


def _sharded_update(job) -> tuple:
    world, path, infos = job
    ffn = _ffn_inputs()
    w1 = _gather(_blocks(path, "step.w1", world), infos, (None, "tp"), ffn["w1"].shape)
    w2 = _gather(_blocks(path, "step.w2", world), infos, ("tp", None), ffn["w2"].shape)
    return w1 - ffn["w1"], w2 - ffn["w2"]


def _assert_update_matches(update: tuple, reference: tuple) -> None:
    for got, want in zip(update, reference):
        dist = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert dist <= UPDATE_TOL, f"update off by {dist:.4f} relative L2 (> {UPDATE_TOL})"


def test_sharded_update_matches_single_device(job):
    """The sharded step moves the weights as the single-device step does, the port's and
    JAX's (not tp times as far, as the JAX sharded step does)."""
    update = _sharded_update(job)
    for name, reference in _single_updates().items():
        assert all(np.linalg.norm(r) > 0 for r in reference), name
        _assert_update_matches(update, reference)


def test_update_check_tells_a_tp_scaled_update_apart(job):
    """The tolerance fails a tp-scaled update: the JAX sharded step's own (its psum's
    transpose sums the replicated cotangent over 'tp' again, tpul2/models/mlp.py:86) and
    the single-device update times tp."""
    world, _, _ = job
    ffn = _ffn_inputs()
    _, tp = _factor(world)
    reference = _single_updates()["jax"]
    with pytest.raises(AssertionError):
        _assert_update_matches(tuple(tp * r for r in reference), reference)
    params = jmlp.FFNParams(jnp.asarray(ffn["w1"], jnp.bfloat16),
                            jnp.asarray(ffn["w2"], jnp.bfloat16))
    step, shard_fn = jmlp.make_sharded_train_step(jpar.make_mesh(world), lr=ranks.LR,
                                                  config=JCFG)
    w1, w2, _ = step(*shard_fn(params, jnp.asarray(ffn["x"], jnp.bfloat16),
                               jnp.asarray(ffn["y"], jnp.bfloat16)))
    jax_sharded = (np.asarray(w1, np.float32) - ffn["w1"], np.asarray(w2, np.float32) - ffn["w2"])
    with pytest.raises(AssertionError):
        _assert_update_matches(jax_sharded, reference)


def test_sharded_step_learns(job):
    _, _, infos = job
    for info in infos:
        losses = info["losses"]
        assert len(losses) == ranks.LEARN_STEPS and losses[-1] < losses[0], losses
    assert len({tuple(i["losses"]) for i in infos}) == 1, "ranks disagree on the loss"
