"""Optimizers: SGD(+momentum, weight decay), AdamW, and the SAM gradient
transform (Foret'21).

Counterpart of ``repro/optim/optimizers.py``. ``opt.init(params) ->
state`` allocates state tensors shaped like ``params`` (the trainer passes
the flat view's ``(M, n)`` worker rows); ``opt.step(params, grads, state,
lr)`` updates ``params`` and ``state`` IN PLACE and returns them — the
port's counterpart of the reference's donated round buffers. The trainer
steps one worker row at a time, passing that row and its slice of the
state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    step: Callable[..., Any]


def worker_state(state, m):
    """The optimizer state of worker row ``m`` (views: in-place updates
    land in the full (M, ...) state)."""
    return {k: v[m] for k, v in state.items()}


def make_optimizer(name: str, *, momentum=0.9, weight_decay=0.0,
                   b1=0.9, b2=0.95, eps=1e-8,
                   state_dtype="float32") -> Optimizer:
    sdt = getattr(torch, state_dtype)
    if name == "sgd":
        def init(params):
            return {"mu": torch.zeros_like(params, dtype=sdt)}

        def step(params, grads, state, lr):
            # g + wd p; mu <- momentum mu + g; p <- p - lr mu (consumes
            # grads: no (n,)-sized temporaries at the main path's width)
            g = grads.to(torch.float32).add_(params, alpha=weight_decay)
            mu = state["mu"]
            mu.mul_(momentum).add_(g)
            params.add_(mu, alpha=-lr)
            return params, state
        return Optimizer("sgd", init, step)

    if name == "adamw":
        def init(params):
            z = torch.zeros_like(params, dtype=torch.float32)
            t = torch.zeros(params.shape[:-1], dtype=torch.int32,
                            device=params.device)
            return {"m": z, "v": z.clone(), "t": t}

        def step(params, grads, state, lr):
            state["t"].add_(1)
            tf = float(state["t"])
            g = grads.to(torch.float32)
            m, v = state["m"], state["v"]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = m / (1 - b1 ** tf)
            vhat = v / (1 - b2 ** tf)
            upd = mhat / (torch.sqrt(vhat) + eps) + weight_decay * params
            params.sub_(lr * upd)
            return params, state
        return Optimizer("adamw", init, step)

    raise ValueError(name)


def value_and_grad(loss_fn, params, batch):
    """``((loss, aux), grad)`` of ``loss_fn(params, batch)`` with respect
    to the tensor ``params`` (``jax.value_and_grad(..., has_aux=True)``).
    The loss is returned detached; the graph is freed before return."""
    leaf = params.detach().requires_grad_(True)
    with torch.enable_grad():
        loss, aux = loss_fn(leaf, batch)
        (g,) = torch.autograd.grad(loss, leaf)
    return (loss.detach(), aux), g


def sam_gradient(loss_fn, params, batch, rho, eps=1e-12):
    """SAM: gradient at the ascent point p + rho * g/||g||.
    Returns ((loss, aux), sharpness-aware grads)."""
    (loss0, aux), g = value_and_grad(loss_fn, params, batch)
    gn = torch.linalg.vector_norm(g.to(torch.float32))
    scale = rho / torch.clamp(gn, min=eps)
    p_adv = (params.to(torch.float32)
             + scale * g.to(torch.float32)).to(params.dtype)
    _, g_adv = value_and_grad(loss_fn, p_adv, batch)
    return (loss0, aux), g_adv
