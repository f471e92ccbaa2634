"""The GEMM consumers: the transformer block and the FFN (``tpul2.models``' counterparts),
and the conversion of the JAX package's params into the port's.

The layouts are the same on both sides ((K, N) weights, f32 biases and scales), so a
conversion changes only the container, the dtype's carrier and the device: each array
keeps its dtype (bf16 arrays, which numpy holds as ``ml_dtypes.bfloat16``, pass through
f32, exactly).
"""

from __future__ import annotations

import numpy as np
import torch

from tpul2_torch.models.mlp import (  # noqa: F401
    FFNParams,
    ffn_forward,
    init_ffn,
    loss_fn,
    make_sharded_train_step,
    train_step,
)
from tpul2_torch.models.transformer import (  # noqa: F401
    BlockParams,
    block_forward,
    block_loss,
    block_train_step,
    block_value_and_grad,
    init_block,
)
from tpul2_torch.utils.platform import check_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _tensor(x, device: str) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name not in _DTYPES:
        raise TypeError(f"unsupported param dtype {x.dtype}")
    dtype = _DTYPES[x.dtype.name]
    return torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=dtype)


def _params(cls, arrays: dict, device: str):
    check_device(device, f"{cls.__name__} from numpy")
    if set(arrays) != set(cls._fields):
        raise ValueError(f"{cls.__name__} needs the fields {cls._fields}, "
                         f"got {sorted(arrays)}")
    return cls(**{name: _tensor(arrays[name], device) for name in cls._fields})


def block_params_from_numpy(arrays: dict, device: str = "cuda") -> BlockParams:
    """``tpul2.models.transformer.BlockParams`` as numpy arrays (``params._asdict()``
    through ``np.asarray``) -> the port's BlockParams on ``device``."""
    return _params(BlockParams, arrays, device)


def ffn_params_from_numpy(arrays: dict, device: str = "cuda") -> FFNParams:
    """``tpul2.models.mlp.FFNParams`` as numpy arrays -> the port's FFNParams on
    ``device``."""
    return _params(FFNParams, arrays, device)
