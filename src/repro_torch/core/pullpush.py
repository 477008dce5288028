"""DPPF pull-push updates on worker-stacked trees (paper §5, Eq. 4/5;
Appendix E.1, D.1): the tree engine's consensus arithmetic.

Counterpart of ``repro/core/pullpush.py``. Every function takes a
worker-stacked tree: a nested dict (``core.engine.tree_items`` order, the
order ``jax.tree_util`` flattens it) whose leaves carry a leading worker
dimension M, in the model's dtype. Centers (``tree_mean0``, the EASGD
center, the lsgd leader) are fp32 trees without the worker dimension.

The per-(worker, leaf) sums and updates go through the hand-written
kernels of ``kernels/pullpush``: every distance is ``sq_dist(leaf[m],
center)``, summed over leaves in tree order, and the Eq. 5 and push
updates are ``apply_update(leaf[m], center, coef[m])``. The coefficients
stay a device vector, so a round makes no host sync. On CPU tensors the
wrappers run their plain versions (the CPU tests).

``pull_only`` keeps the reference's convex form ``(1 - α) a + α c`` in
plain torch: at α = 1 it gives c exactly (hard averaging collapses the
fleet to distance 0), which ``a + (c - a)·1`` would not. ``exact_push``
and ``push_terms_norms`` are plain torch around ``sq_dist`` distances.
Functions return new tensors, as the reference does; ``push_only(...,
out=stacked)`` writes in place for a caller that owns its input.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import tree_from_items, tree_items, tree_map
from repro_torch.kernels.pullpush import apply_update, sq_dist


def _rows(leaf):
    """The flat row views ``leaf[m].view(-1)`` of a stacked leaf (``view``:
    writes through them must reach the leaf)."""
    return leaf.view(leaf.shape[0], -1)


def _bcast(v, a):
    """A per-worker (M,) vector broadcast over a stacked leaf (M, ...)."""
    return v.reshape(v.shape + (1,) * (a.dim() - 1)).to(torch.float32)


# ---------------------------------------------------------------------------
# Stacked-tree utilities
# ---------------------------------------------------------------------------

def tree_mean0(stacked):
    """x_A: fp32 mean over the worker dimension."""
    return tree_map(lambda a: torch.mean(a, dim=0, dtype=torch.float32),
                    stacked)


def worker_sq_dists(stacked, center):
    """``||x_m - c||^2`` per worker, summed over leaves in tree order:
    one ``sq_dist`` per (worker, leaf). -> (M,) fp32."""
    parts = []
    for (_, a), (_, c) in zip(tree_items(stacked), tree_items(center)):
        cv = c.reshape(-1)
        parts.append(torch.stack([sq_dist(row, cv) for row in _rows(a)]))
    return torch.sum(torch.stack(parts), dim=0)


def worker_dists(stacked, center=None):
    """``||x_m - x_A||`` per worker -> (M,): the relaxed MV quantity
    (consensus distance, Fig. 2b)."""
    if center is None:
        center = tree_mean0(stacked)
    return torch.sqrt(worker_sq_dists(stacked, center))


def _update(stacked, center, coef, out=None):
    """``x_m + (c - x_m)·coef_m`` leaf by leaf through ``apply_update``;
    ``out`` (a tree like ``stacked``, possibly itself) receives it."""
    if out is None:
        out = tree_map(torch.empty_like, stacked)
    for (_, a), (_, c), (_, o) in zip(tree_items(stacked), tree_items(center),
                                      tree_items(out)):
        cv = c.reshape(-1)
        for m, (row, orow) in enumerate(zip(_rows(a), _rows(o))):
            apply_update(row, cv, coef[m:m + 1], out=orow)
    return out


# ---------------------------------------------------------------------------
# Eq. 5: fused pull-push (x_C = x_A)
# ---------------------------------------------------------------------------

def pullpush(stacked, alpha, lam, eps=1e-12):
    """``x_m <- x_m + (x_A - x_m)(alpha - lam / ||x_m - x_A||)``.
    Returns ``(new_stacked, metrics)``."""
    center = tree_mean0(stacked)
    r = worker_dists(stacked, center)                      # (M,)
    coef = alpha - lam / torch.clamp(r, min=eps)           # (M,)
    new = _update(stacked, center, coef)
    # post-update distance: new gap = gap * (1 - coef), mean preserved
    r_post = r * torch.abs(1.0 - coef)
    f32 = dict(dtype=torch.float32, device=r.device)
    metrics = {
        "consensus_dist": torch.mean(r_post),
        "pre_dist": torch.mean(r),
        "pull_force": alpha * torch.mean(r),
        "push_force": torch.as_tensor(lam, **f32),
    }
    return new, metrics


def pull_only(stacked, target, alpha):
    """Soft consensus ``x_m <- (1-alpha) x_m + alpha x_C`` in the convex
    form. ``target`` is a center tree (no worker dim) or a stacked tree.
    Worker by worker, so that fp32 temporaries stay one row large."""
    def leaf(a, c):
        out = torch.empty_like(a)
        for m in range(a.shape[0]):
            cf = (c[m] if c.dim() == a.dim() else c).to(torch.float32)
            out[m] = (1.0 - alpha) * a[m].to(torch.float32) + alpha * cf
        return out
    return tree_map(leaf, stacked, target)


def push_only(stacked, lam, center=None, eps=1e-12, *, out=None):
    """``x_m <- x_m + lam (x_m - c)/||x_m - c||`` (push force alone), c the
    worker mean unless given (the lsgd leader). Through ``apply_update``
    with coefficient ``-lam/||x_m - c||``: ``x + (c - x)(-s)`` is
    ``x + (x - c) s`` exactly, since negation is exact. ``out`` may be
    ``stacked`` (in place)."""
    if center is None:
        center = tree_mean0(stacked)
    r = worker_dists(stacked, center)
    return _update(stacked, center, -(lam / torch.clamp(r, min=eps)), out)


# ---------------------------------------------------------------------------
# Exact two-term update (Appendix E.1 / ablation D.1)
# ---------------------------------------------------------------------------

def _units(stacked, center, r, eps):
    """Per leaf: the unit directions ``u_m = (x_m - c)/||x_m - c||`` and
    their worker mean (the second collective)."""
    inv = 1.0 / torch.clamp(r, min=eps)
    for (path, a), (_, c) in zip(tree_items(stacked), tree_items(center)):
        u = (a.to(torch.float32) - c[None]) * _bcast(inv, a)
        yield path, a, u, torch.mean(u, dim=0)


def exact_push(stacked, lam_r, eps=1e-12):
    """``-lam_r dR/dx_m = (lam_r/M^2)(M u_m - sum_j u_j)``: keeps the
    second term the paper drops."""
    center = tree_mean0(stacked)
    r = worker_dists(stacked, center)
    M = r.shape[0]
    return tree_from_items([
        (path, (a.to(torch.float32) + (lam_r / M) * (u - mu[None]))
         .to(a.dtype))
        for path, a, u, mu in _units(stacked, center, r, eps)])


def push_terms_norms(stacked, lam_r, eps=1e-12):
    """``(||T1||, ||T2||, ||T1+T2||)`` per worker (Figure 7 ablation)."""
    center = tree_mean0(stacked)
    r = worker_dists(stacked, center)
    M = r.shape[0]
    s = lam_r / M
    n1 = n12 = 0.0
    n2 = 0.0
    for _, a, u, mu in _units(stacked, center, r, eps):
        t1, t2 = s * u, s * mu
        n1 = n1 + torch.sum(torch.square(t1).reshape(M, -1), dim=1)
        n2 = n2 + torch.sum(torch.square(t2))
        n12 = n12 + torch.sum(torch.square(t1 - t2[None]).reshape(M, -1),
                              dim=1)
    return torch.sqrt(n1), torch.sqrt(n2), torch.sqrt(n12)
