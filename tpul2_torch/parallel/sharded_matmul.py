"""Sharded GEMMs over a device mesh: the port's kernels on each rank's shard, stitched by
``torch.distributed`` collectives.

Counterpart of ``tpul2/parallel/sharded_matmul.py``, whose strategies run the Pallas kernel
under ``shard_map`` and reduce with XLA's collectives.  Here each function is the body of
that ``shard_map``, run SPMD: every rank of the mesh calls it with its own blocks (plain
local tensors, cut by ``shard_array``) and gets its own block of the output back.  Each
local product goes through ``dispatch.matmul`` (the tuned DB, the heuristic, or the
caller's ``config``), so it reaches the wgmma carry, single-K or staged body, or the
sentinel, as the JAX locals reach Pallas through their DB.  The collectives reduce over
the process group of one mesh axis (``mesh.get_group(axis)``): ``dist.all_reduce`` for
``psum``, and ``dist.reduce_scatter`` over contiguous N chunks for ``psum_scatter`` on
dimension 1 (gloo's ``reduce_scatter_tensor`` scatters dimension 0 only).  DTensor is not
used: its matmul would run aten's, not the port's kernels.

Strategies (block shapes for a mesh of ``dp`` x ``tp`` ranks):
  dp_matmul          A (M/dp, K) x B (K, N) -> (M/dp, N).  No communication.
  tp_matmul          A (M, K) x B (K, N/tp) -> (M, N/tp).  No communication.
  kshard_matmul      A (M, K/tp) x B (K/tp, N): the f32 partial, summed over 'tp' ->
                     (M, N) on every rank (Megatron's row-parallel all-reduce).
  kshard_scatter_matmul  the same partial, reduce-scattered on N -> (M, N/tp): 1/tp of
                     the all-reduce's bytes where the consumer takes a column shard.
  sharded_matmul_2d  A (M/dp, K/tp) x B (K/tp, N): the f32 partial summed over 'tp' ->
                     (M/dp, N).
Each output is in A's dtype, the f32 sums cast once after the reduction.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpul2_torch.config import KernelConfig
from tpul2_torch.dispatch import matmul


class P(tuple):
    """Partition spec: one mesh axis name (or None: not split) per tensor dimension,
    ``jax.sharding.PartitionSpec``'s role, e.g. ``P("dp", None)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def _axis(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def shard_array(x: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (``P`` or a tuple of axis names or None per
    dimension), by the rank's mesh coordinate; contiguous.  Every split dimension must
    divide by its axis' size."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    if len(spec) > x.ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than x has dims {x.ndim}")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        i = _axis(mesh, axis)
        parts = mesh.shape[i]
        if x.shape[dim] % parts:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split into "
                             f"{parts} along {axis!r}")
        size = x.shape[dim] // parts
        x = x.narrow(dim, coord[i] * size, size)
    return x.contiguous()


def _partial(a, b, acc, config) -> torch.Tensor:
    return matmul(a, b, acc=acc, config=config, out_dtype=torch.float32)


def _psum(part: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    dist.all_reduce(part, group=mesh.get_group(_axis(mesh, axis)))
    return part


def dp_matmul(a, b, mesh: DeviceMesh, axis: str = "dp", acc: str = "float32",
              config: Optional[KernelConfig] = None) -> torch.Tensor:
    """A's row block over ``axis``, B replicated -> this rank's row block.  No comms."""
    _axis(mesh, axis)
    return matmul(a, b, acc=acc, config=config)


def tp_matmul(a, b, mesh: DeviceMesh, axis: str = "tp", acc: str = "float32",
              config: Optional[KernelConfig] = None) -> torch.Tensor:
    """A replicated, B's column block over ``axis`` -> this rank's column block."""
    _axis(mesh, axis)
    return matmul(a, b, acc=acc, config=config)


def kshard_matmul(a, b, mesh: DeviceMesh, axis: str = "tp", acc: str = "float32",
                  config: Optional[KernelConfig] = None) -> torch.Tensor:
    """K sharded over ``axis``: A (M, K/t) and B (K/t, N) blocks; the f32 partial product
    summed over the axis -> (M, N) on every rank."""
    return _psum(_partial(a, b, acc, config), mesh, axis).to(a.dtype)


def kshard_scatter_matmul(a, b, mesh: DeviceMesh, axis: str = "tp", acc: str = "float32",
                          config: Optional[KernelConfig] = None) -> torch.Tensor:
    """K sharded over ``axis`` with a reduce-scatter epilogue: the f32 partial (M, N) is
    summed over the axis and scattered on N -> this rank's (M, N/t) column block
    (``psum_scatter(scatter_dimension=1, tiled=True)``)."""
    part = _partial(a, b, acc, config)
    t = mesh.shape[_axis(mesh, axis)]
    if part.shape[1] % t:
        raise ValueError(f"N = {part.shape[1]} does not split into {t} along {axis!r}")
    chunks = [c.contiguous() for c in part.chunk(t, dim=1)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=mesh.get_group(_axis(mesh, axis)))
    return out.to(a.dtype)


def sharded_matmul_2d(a, b, mesh: DeviceMesh, m_axis: str = "dp", k_axis: str = "tp",
                      acc: str = "float32",
                      config: Optional[KernelConfig] = None) -> torch.Tensor:
    """M over ``m_axis`` and K over ``k_axis``: A (M/d, K/t) and B (K/t, N) blocks; the f32
    partial summed over ``k_axis`` -> this rank's (M/d, N) row block."""
    _axis(mesh, m_axis)
    return _psum(_partial(a, b, acc, config), mesh, k_axis).to(a.dtype)
