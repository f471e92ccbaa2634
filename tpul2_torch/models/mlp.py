"""Transformer FFN on the port's GEMMs: y = gelu(x @ W1) @ W2.

Counterpart of ``tpul2/models/mlp.py`` (``FFNParams``, ``init_ffn``, ``ffn_forward``,
``loss_fn``, ``train_step``).  Unlike the block, h comes out of the first product in f32
and gelu (the tanh form, as ``jax.nn.gelu``) runs outside the kernel, then h is cast to
x's dtype for the second product.  ``make_sharded_train_step`` is the Megatron FFN step
over a ('dp', 'tp') mesh of ``tpul2_torch.parallel``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpul2_torch.config import KernelConfig
from tpul2_torch.dispatch import matmul
from tpul2_torch.models._train import sgd_update, value_and_grad
from tpul2_torch.parallel.sharded_matmul import P, shard_array
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


class _SumOverGroup(torch.autograd.Function):
    """Sum of each rank's partial over a process group, differentiable.  Every rank of the
    group then holds the same sum and takes the same loss of it, so the cotangent of its
    own partial is the cotangent of the sum it holds: the backward is the identity.  (The
    JAX step's ``psum`` under ``shard_map(check_vma=False)`` transposes to a second psum
    of that replicated cotangent, which scales the gradient by the group's size.)"""

    @staticmethod
    def forward(ctx, part, group):
        out = part.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def make_sharded_train_step(mesh, lr: float = 1e-3, config: Optional[KernelConfig] = None,
                            acc: str = "float32") -> tuple:
    """Tensor- and data-parallel SGD step over a ('dp', 'tp') mesh: ``tpul2.models.mlp.
    make_sharded_train_step``'s layout and math, SPMD on each rank's blocks.

      x, y : (B, d_model)        -> P('dp', None)   batch over dp
      W1   : (d_model, d_ff)     -> P(None, 'tp')   column-parallel
      W2   : (d_ff, d_model)     -> P('tp', None)   row-parallel

    The local forward: FFN-1 in f32, gelu (tanh form), the cast to x's dtype, FFN-2 in
    f32, then the sum over 'tp' (differentiable, the identity backward); then the MSE.
    The grads come through ``value_and_grad`` (so ``GemmVjp`` runs), grads and loss are
    averaged over 'dp' in f32 (one all-reduce of one flat buffer), and ``sgd_update``
    applies them: each rank's update is its block of the single-device step's update.
    Returns ``(step_fn, shard_fn)``:
    ``step_fn(w1, w2, x, y) -> (w1, w2, loss)`` on this rank's blocks (loss replicated);
    ``shard_fn(params, x, y) -> (w1, w2, x, y)`` cuts this rank's blocks of full tensors
    (``FFNParams``, e.g. ``models.ffn_params_from_numpy`` of the JAX params)."""
    tp_group = mesh.get_group("tp")
    dp_group = mesh.get_group("dp")
    dp = mesh.shape[mesh.mesh_dim_names.index("dp")]

    def local_loss(params: FFNParams, x, y) -> torch.Tensor:
        h = matmul(x, params.w1, acc=acc, config=config, out_dtype=torch.float32)
        h = F.gelu(h, approximate="tanh").to(x.dtype)
        out = matmul(h, params.w2, acc=acc, config=config, out_dtype=torch.float32)
        pred = _SumOverGroup.apply(out, tp_group)
        return ((pred - y.float()) ** 2).mean()

    def step_fn(w1, w2, x, y) -> tuple:
        params = FFNParams(w1, w2)
        loss, grads = value_and_grad(local_loss, params, x, y)
        # one all-reduce over 'dp' for both grads and the loss, in one flat f32 buffer
        flat = torch.cat([grads.w1.reshape(-1).float(), grads.w2.reshape(-1).float(),
                          loss.reshape(1).float()])
        dist.all_reduce(flat, group=dp_group)
        flat /= dp
        g1, g2, mean_loss = flat.split([w1.numel(), w2.numel(), 1])
        new = sgd_update(params, FFNParams(g1.view(w1.shape), g2.view(w2.shape)), lr)
        return new.w1, new.w2, mean_loss.reshape(())

    def shard_fn(params: FFNParams, x, y) -> tuple:
        return (shard_array(params.w1, mesh, P(None, "tp")),
                shard_array(params.w2, mesh, P("tp", None)),
                shard_array(x, mesh, P("dp", None)), shard_array(y, mesh, P("dp", None)))

    return step_fn, shard_fn
