"""Transformer block on the port's GEMMs: the flagship consumer.

Counterpart of ``tpul2/models/transformer.py``: a pre-norm multi-head attention + FFN block
whose every product goes through the tuned dispatch: the QKV and output projections and
the FFN through ``dispatch.matmul`` (bias, and gelu on the first FFN product, in the
kernel's epilogue), the attention scores and mixing through ``dispatch.batched_matmul``.
Params are a NamedTuple of tensors with the JAX field names and layouts ((K, N) weights,
f32 biases and scales), so ``models.block_params_from_numpy`` carries JAX params across.

The batched kernel takes contiguous operands only and has no 'nk' layout (neither has the
JAX one), so q, kᵀ and v are made contiguous per head before the two products.  The
scores stay f32 through the causal mask (-inf before the softmax) and the softmax, as in
JAX.  The training step is plain SGD: the update in f32, cast back to each param's dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpul2_torch.config import KernelConfig
from tpul2_torch.dispatch import batched_matmul, matmul
from tpul2_torch.models._train import sgd_update, value_and_grad
from tpul2_torch.utils.platform import check_device


class BlockParams(NamedTuple):
    wqkv: torch.Tensor       # (d_model, 3*d_model)
    bqkv: torch.Tensor       # (3*d_model,) f32
    wo: torch.Tensor         # (d_model, d_model)
    bo: torch.Tensor         # (d_model,) f32
    w1: torch.Tensor         # (d_model, d_ff)
    b1: torch.Tensor         # (d_ff,) f32
    w2: torch.Tensor         # (d_ff, d_model)
    b2: torch.Tensor         # (d_model,) f32
    ln1_scale: torch.Tensor  # (d_model,) f32
    ln2_scale: torch.Tensor  # (d_model,) f32


def init_block(gen: torch.Generator, d_model: int, d_ff: int,
               dtype: torch.dtype = torch.bfloat16, device: str = "cuda") -> BlockParams:
    """He-normal weights drawn from ``gen`` (on its own device), zero biases, unit scales,
    as ``tpul2.models.transformer.init_block``; the numbers differ from JAX's draws."""
    check_device(device, "init_block")

    def w(fan_in, shape):
        x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return (x * (2.0 / fan_in) ** 0.5).to(device=device, dtype=dtype)

    def const(value, n):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    return BlockParams(
        wqkv=w(d_model, (d_model, 3 * d_model)), bqkv=const(0.0, 3 * d_model),
        wo=w(d_model, (d_model, d_model)), bo=const(0.0, d_model),
        w1=w(d_model, (d_model, d_ff)), b1=const(0.0, d_ff),
        w2=w(d_ff, (d_ff, d_model)), b2=const(0.0, d_model),
        ln1_scale=const(1.0, d_model), ln2_scale=const(1.0, d_model))


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * rms * scale).to(x.dtype)


def block_forward(params: BlockParams, x: torch.Tensor, n_heads: int,
                  config: Optional[KernelConfig] = None,
                  causal: bool = True) -> torch.Tensor:
    """x: (seq, d_model) -> (seq, d_model).  Pre-norm MHA + FFN block."""
    s, d = x.shape
    hd = d // n_heads
    if hd * n_heads != d:
        raise ValueError(f"d_model {d} must divide into {n_heads} heads")

    # --- attention ---
    h = _rmsnorm(x, params.ln1_scale)
    qkv = matmul(h, params.wqkv, bias=params.bqkv, config=config)  # (s, 3d)
    q, k_, v = qkv.split(d, dim=1)

    def heads(t):  # (s, d) -> (n_heads, s, hd), contiguous for the batched kernel
        return t.reshape(s, n_heads, hd).transpose(0, 1).contiguous()

    q, v = heads(q), heads(v)
    k_t = k_.reshape(s, n_heads, hd).permute(1, 2, 0).contiguous()  # (n_heads, hd, s)
    scores = batched_matmul(q, k_t, config=config, out_dtype=torch.float32)  # (h, s, s)
    scores = scores / (hd ** 0.5)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(mask, scores, float("-inf"))
    probs = F.softmax(scores, dim=-1).to(x.dtype)
    ctx = batched_matmul(probs, v, config=config)  # (h, s, hd)
    ctx = ctx.transpose(0, 1).reshape(s, d)
    attn_out = matmul(ctx, params.wo, bias=params.bo, config=config)
    x = x + attn_out

    # --- FFN (bias + gelu fused into the first GEMM's epilogue) ---
    h = _rmsnorm(x, params.ln2_scale)
    h = matmul(h, params.w1, bias=params.b1, activation="gelu", config=config)
    h = matmul(h, params.w2, bias=params.b2, config=config)
    return x + h


def block_loss(params: BlockParams, x, y, n_heads: int,
               config: Optional[KernelConfig] = None) -> torch.Tensor:
    pred = block_forward(params, x, n_heads, config=config)
    return ((pred.float() - y.float()) ** 2).mean()


def block_value_and_grad(params: BlockParams, x, y, n_heads: int,
                         config: Optional[KernelConfig] = None) -> tuple:
    """(loss, grads): ``jax.value_and_grad(block_loss)``; grads a BlockParams."""
    return value_and_grad(block_loss, params, x, y, n_heads, config=config)


def block_train_step(params: BlockParams, x, y, n_heads: int, lr: float = 1e-3,
                     config: Optional[KernelConfig] = None) -> tuple:
    """One SGD step: (new params, loss)."""
    loss, grads = block_value_and_grad(params, x, y, n_heads, config=config)
    return sgd_update(params, grads, lr), loss
