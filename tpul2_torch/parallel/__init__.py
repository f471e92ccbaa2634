"""Sharded GEMMs over a ``torch.distributed`` device mesh: ``tpul2.parallel``'s counterpart."""

from tpul2_torch.parallel.mesh import make_mesh  # noqa: F401
from tpul2_torch.parallel.sharded_matmul import (  # noqa: F401
    P,
    dp_matmul,
    kshard_matmul,
    kshard_scatter_matmul,
    shard_array,
    sharded_matmul_2d,
    tp_matmul,
)
