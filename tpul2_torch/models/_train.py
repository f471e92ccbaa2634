"""The two training pieces the models share: ``jax.value_and_grad`` over a params NamedTuple
and the SGD update of the JAX package's train steps."""

from __future__ import annotations

import torch


def value_and_grad(loss_fn, params, *args, **kw) -> tuple:
    """(loss, grads) of ``loss_fn(params, *args, **kw)`` with respect to every param; the
    loss detached, the grads a NamedTuple of the params' type."""
    leaves = [p.detach().requires_grad_() for p in params]
    with torch.enable_grad():
        loss = loss_fn(type(params)(*leaves), *args, **kw)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), type(params)(*grads)


def sgd_update(params, grads, lr: float):
    """p - lr·g in f32, cast back to each param's dtype."""
    with torch.no_grad():
        return type(params)(*((p.float() - lr * g.float()).to(p.dtype)
                              for p, g in zip(params, grads)))
