"""Optimizers: SGD(+momentum, weight decay), AdamW, and the SAM gradient
transform (Foret'21).

Counterpart of ``repro/optim/optimizers.py``. ``params`` is a tensor or
a tree of tensors (``core.engine.tree_items``). ``opt.init(params,
workers=None) -> state`` allocates state leaves shaped like ``params``;
``workers=M`` marks a leading worker dimension of M (the reference's
``jax.vmap(opt.init)``): AdamW's step count ``t`` is then one scalar per
worker, ``(M,)``, and ``()`` without. The trainer passes the flat view's
``(M, n)`` worker rows, or the tree engine's stacked tree, and steps one
worker at a time with ``worker_state(state, m)``. ``opt.step(params,
grads, state, lr)`` updates ``params`` and ``state`` IN PLACE, leaf by
leaf, and returns them — the port's counterpart of the reference's
donated round buffers. Each leaf keeps its dtype: a bf16 leaf rounds to
bf16 after every step, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.engine import tree_from_items, tree_items


def leaves(tree):
    """The leaves of a tensor-or-tree, in tree order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for _, leaf in tree_items(tree)]


def tree_like(tree, new_leaves):
    """A tensor-or-tree of ``tree``'s structure with ``new_leaves``."""
    if isinstance(tree, torch.Tensor):
        (leaf,) = new_leaves
        return leaf
    return tree_from_items([(path, leaf) for (path, _), leaf in
                            zip(tree_items(tree), new_leaves)])


def _map(fn, tree):
    return tree_like(tree, [fn(leaf) for leaf in leaves(tree)])


def grad_norm(grads):
    """The global L2 norm of a gradient tensor-or-tree, in fp32, leaf norms
    first (no gradient-sized temporary)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in leaves(grads)]
    return norms[0] if len(norms) == 1 else \
        torch.linalg.vector_norm(torch.stack(norms))


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    step: Callable[..., Any]


def worker_state(state, m):
    """The optimizer state of worker ``m`` (views: in-place updates land in
    the full (M, ...) state)."""
    return {k: _map(lambda v: v[m], v) for k, v in state.items()}


def make_optimizer(name: str, *, momentum=0.9, weight_decay=0.0,
                   b1=0.9, b2=0.95, eps=1e-8,
                   state_dtype="float32") -> Optimizer:
    sdt = getattr(torch, state_dtype)
    if name == "sgd":
        def init(params, workers=None):
            return {"mu": _map(lambda p: torch.zeros_like(p, dtype=sdt),
                                   params)}

        def step(params, grads, state, lr):
            # g + wd p; mu <- momentum mu + g; p <- p - lr mu (no (n,)-sized
            # temporaries beyond g at the main path's width)
            for p, gr, mu in zip(leaves(params), leaves(grads),
                                 leaves(state["mu"])):
                g = gr.to(torch.float32).add_(p, alpha=weight_decay)
                mu.mul_(momentum).add_(g)
                p.add_(mu, alpha=-lr)
            return params, state
        return Optimizer("sgd", init, step)

    if name == "adamw":
        def init(params, workers=None):
            first = leaves(params)[0]
            z = _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
            t = torch.zeros(() if workers is None else (workers,),
                            dtype=torch.int32, device=first.device)
            return {"m": z, "v": _map(torch.clone, z), "t": t}

        def step(params, grads, state, lr):
            state["t"].add_(1)
            tf = float(state["t"])
            for p, gr, m, v in zip(leaves(params), leaves(grads),
                                   leaves(state["m"]), leaves(state["v"])):
                g = gr.to(torch.float32)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m / (1 - b1 ** tf)
                vhat = v / (1 - b2 ** tf)
                upd = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p
                p.sub_(lr * upd)
            return params, state
        return Optimizer("adamw", init, step)

    raise ValueError(name)


def value_and_grad(loss_fn, params, batch):
    """``((loss, aux), grad)`` of ``loss_fn(params, batch)`` with respect
    to ``params``, a tensor or a tree (``jax.value_and_grad(...,
    has_aux=True)``): the gradient has params' structure. The loss is
    returned detached; the graph is freed before return."""
    ls = [leaf.detach().requires_grad_(True) for leaf in leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_like(params, ls), batch)
        gs = torch.autograd.grad(loss, ls)
    return (loss.detach(), aux), tree_like(params, list(gs))


def sam_gradient(loss_fn, params, batch, rho, eps=1e-12):
    """SAM: gradient at the ascent point p + rho * g/||g||.
    Returns ((loss, aux), sharpness-aware grads)."""
    (loss0, aux), g = value_and_grad(loss_fn, params, batch)
    scale = rho / torch.clamp(grad_norm(g), min=eps)
    p_adv = tree_like(params, [
        (p.to(torch.float32) + scale * gg.to(torch.float32)).to(p.dtype)
        for p, gg in zip(leaves(params), leaves(g))])
    _, g_adv = value_and_grad(loss_fn, p_adv, batch)
    return (loss0, aux), g_adv
