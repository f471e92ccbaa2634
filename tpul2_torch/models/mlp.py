"""Transformer FFN on the port's GEMMs: y = gelu(x @ W1) @ W2.

Counterpart of ``tpul2/models/mlp.py`` (``FFNParams``, ``init_ffn``, ``ffn_forward``,
``loss_fn``, ``train_step``).  Unlike the block, h comes out of the first product in f32
and gelu (the tanh form, as ``jax.nn.gelu``) runs outside the kernel, then h is cast to
x's dtype for the second product.  ``make_sharded_train_step`` waits for the port of
``tpul2.parallel``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpul2_torch.config import KernelConfig
from tpul2_torch.dispatch import matmul
from tpul2_torch.models._train import sgd_update, value_and_grad
from tpul2_torch.utils.platform import check_device


class FFNParams(NamedTuple):
    w1: torch.Tensor  # (d_model, d_ff)
    w2: torch.Tensor  # (d_ff, d_model)


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.bfloat16, device: str = "cuda") -> FFNParams:
    """He-normal weights drawn from ``gen`` (on its own device), as
    ``tpul2.models.mlp.init_ffn``; the numbers differ from JAX's draws."""
    check_device(device, "init_ffn")

    def w(fan_in, shape):
        x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return (x * (2.0 / fan_in) ** 0.5).to(device=device, dtype=dtype)

    return FFNParams(w1=w(d_model, (d_model, d_ff)), w2=w(d_ff, (d_ff, d_model)))


def ffn_forward(params: FFNParams, x: torch.Tensor,
                config: Optional[KernelConfig] = None, acc: str = "float32") -> torch.Tensor:
    """y = gelu(x @ W1) @ W2, both products through the tuned dispatch."""
    h = matmul(x, params.w1, acc=acc, config=config, out_dtype=torch.float32)
    h = F.gelu(h, approximate="tanh").to(x.dtype)
    return matmul(h, params.w2, acc=acc, config=config)


def loss_fn(params: FFNParams, x, y, **kw) -> torch.Tensor:
    pred = ffn_forward(params, x, **kw).float()
    return ((pred - y.float()) ** 2).mean()


def train_step(params: FFNParams, x, y, lr: float = 1e-3, **kw) -> tuple:
    """One SGD step on one device: (new params, loss)."""
    loss, grads = value_and_grad(loss_fn, params, x, y, **kw)
    return sgd_update(params, grads, lr), loss
