"""Mean Valley / Inverse Mean Valley sharpness measure (paper §4, Alg. 2).

Counterpart of ``repro/core/valley.py``. Offline analysis tool: given
converged worker parameters, line-search from the average x_A along each
worker direction until the train loss reaches kappa * L_A; MV is the mean
boundary distance, Inv. MV its additive inverse. Every loss is evaluated
under ``torch.no_grad()`` and read with ``float``: one host sync a probe
(cheap at the benchmark MLP's size).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import tree_items, tree_map


def normalize_params(tree):
    """Scale-invariance normalization (paper B.1, following Bisla'22):
    every leaf is rescaled to unit Frobenius norm (zero leaves untouched)."""
    def leaf(a):
        n = torch.sqrt(torch.sum(torch.square(a.to(torch.float32))))
        return torch.where(n > 0, a / n, a).to(a.dtype)
    return tree_map(leaf, tree)


def _axpy(x, d, t):
    return tree_map(lambda a, b: (a.to(torch.float32)
                                  + t * b.to(torch.float32)), x, d)


def _tree_norm(t):
    return float(torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                                for _, l in tree_items(t))))


def mean_valley(loss_fn, workers, *, kappa=2.0, step=0.1, max_steps=200,
                normalize=False, bisect_iters=25):
    """Algorithm 2. ``workers``: list of parameter trees (one per worker);
    ``loss_fn(params) -> scalar`` evaluates the train loss (full data or a
    fixed large batch).

    The coarse line search only BRACKETS the kappa-contour crossing; the
    crossing itself is refined with ``bisect_iters`` of bisection inside
    the bracketing step, so MV is not quantized to the coarse ``step``. A
    direction whose loss never reaches ``kappa * L_A`` within
    ``max_steps * step`` saturates at that boundary and is flagged in the
    returned per-worker ``hit_boundary`` list.

    Returns dict with mv, inv_mv, per-worker betas, per-worker
    hit_boundary flags, loss_at_avg, kappa.
    """
    with torch.no_grad():
        return _mean_valley(loss_fn, workers, kappa, step, max_steps,
                            normalize, bisect_iters)


def _mean_valley(loss_fn, workers, kappa, step, max_steps, normalize,
                 bisect_iters):
    if normalize:
        workers = [normalize_params(w) for w in workers]
    M = len(workers)
    # the reference's order: 0 + w_0 + w_1 + ..., then / M, in fp32
    x_a = tree_map(lambda *ls: sum(l.to(torch.float32) for l in ls) / M,
                   *workers)
    l_a = float(loss_fn(x_a))
    target = kappa * l_a

    betas, hit_boundary = [], []
    for w in workers:
        d = tree_map(lambda a, c: a.to(torch.float32) - c, w, x_a)
        n = _tree_norm(d)
        if n == 0.0:
            betas.append(0.0)
            hit_boundary.append(False)
            continue
        d = tree_map(lambda a: a / n, d)
        beta, hit = 0.0, True
        for _ in range(max_steps):
            beta += step
            if float(loss_fn(_axpy(x_a, d, beta))) >= target:
                hit = False
                lo, hi = beta - step, beta   # bracket: L(lo) < target <= L(hi)
                for _ in range(bisect_iters):
                    mid = 0.5 * (lo + hi)
                    if float(loss_fn(_axpy(x_a, d, mid))) >= target:
                        hi = mid
                    else:
                        lo = mid
                beta = 0.5 * (lo + hi)
                break
        betas.append(beta)
        hit_boundary.append(hit)
    mv = float(np.mean(betas))
    return {"mv": mv, "inv_mv": -mv, "betas": betas,
            "hit_boundary": hit_boundary, "loss_at_avg": l_a,
            "kappa": kappa}
