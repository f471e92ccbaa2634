"""Device mesh for sharded execution over ``torch.distributed``.

Counterpart of ``tpul2/parallel/mesh.py``: the same near-square (dp, tp) factorization of
the devices, so that both the batch (data) and the feature (model) axes shard.  The mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the default process group, which
the caller initializes (NCCL on the cards, gloo on the CPU); each of its axes has a
process group (``mesh.get_group(axis)``) that the collectives of
``parallel.sharded_matmul`` reduce over.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _factor(n: int) -> tuple:
    """Near-square factorization n = a*b with a <= b."""
    a = int(n ** 0.5)
    while a > 1 and n % a:
        a -= 1
    return a, n // a


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("dp", "tp"),
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D or 2-D mesh over the first ``n_devices`` ranks of the default process group
    (all of them by default): ('dp', 'tp') = data-parallel x tensor-parallel, shaped by
    ``_factor`` (8 ranks -> (2, 4), 4 -> (2, 2), 2 -> (1, 2)).  ``device_type`` is the
    mesh's device ('cuda' on the cards, 'cpu' for a gloo group).  Every rank of the
    group calls it; a rank outside the mesh has no coordinate."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"asked for {n_devices} devices, have {world}")
    if len(axis_names) == 1:
        shape = (n_devices,)
    elif len(axis_names) == 2:
        shape = _factor(n_devices)
    else:
        raise ValueError("make_mesh supports 1D or 2D meshes")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))
