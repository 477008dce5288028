"""Non-IID / Federated Learning substrate (paper §8.3, Table 5, §C.3):
Dirichlet partitioning, SCAFFOLD (Karimireddy'20), FedLESAM (Fan'24), and
their DPPF couplings (aggregation replaced by the Eq. 5 pull-push update;
control variates / perturbations untouched).

Counterpart of ``repro/core/fl.py``. The reference vmaps over workers and
scans over the tau local steps; here a loop over workers runs each
worker's steps in turn. The DPPF aggregation is ``core.pullpush.pullpush``,
whose distances and updates run through the ``sq_dist`` / ``apply_update``
kernels on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pullpush as pp
from repro_torch.core.engine import tree_at, tree_items, tree_map, tree_stack
from repro_torch.optim import value_and_grad


# ---------------------------------------------------------------------------
# Dirichlet non-IID partition (fixed at init, no reshuffling — §C.3)
# ---------------------------------------------------------------------------

def dirichlet_partition(labels, n_workers, alpha, seed=0):
    """Split sample indices across workers with Dir(alpha) class skew.
    Returns a list of index arrays (equal sizes, truncated)."""
    rng = np.random.default_rng(seed)
    labels = _numpy(labels)
    classes = np.unique(labels)
    shards = [[] for _ in range(n_workers)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(n_workers))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for w, part in enumerate(np.split(idx, cuts)):
            shards[w].extend(part.tolist())
    size = min(len(s) for s in shards)
    return [np.asarray(sorted(rng.permutation(s)[:size])) for s in shards]


def heterogeneity(shards, labels, n_classes):
    """Mean total-variation distance of shard label distributions from the
    global distribution (diagnostic)."""
    labels = _numpy(labels)
    glob = np.bincount(labels, minlength=n_classes) / len(labels)
    tvs = []
    for s in shards:
        loc = np.bincount(labels[s], minlength=n_classes) / len(s)
        tvs.append(0.5 * np.abs(loc - glob).sum())
    return float(np.mean(tvs))


def _numpy(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# FL rounds (a loop over workers; stacked params)
# ---------------------------------------------------------------------------

def _f32(a):
    return a.to(torch.float32)


def init_fl_state(method, stacked):
    """SCAFFOLD: server control c + per-worker controls c_m (fp32)."""
    st = {"x_prev_global": pp.tree_mean0(stacked)}
    if method == "scaffold":
        st["c"] = tree_map(torch.zeros_like, pp.tree_mean0(stacked))
        st["c_m"] = tree_map(
            lambda a: torch.zeros_like(a, dtype=torch.float32), stacked)
    return st


def fl_round(method, loss_fn, stacked, state, batches, lr, *,
             dppf=None, lam_t=0.0, rho=1e-3, eps=1e-12):
    """One FL communication round.

    batches: dict of tensors with leading dims (tau, M, ...) — per local
    step, per worker. Aggregation: FedAvg (dppf None) or DPPF Eq. 5.
    Returns (stacked, state, metrics); the inputs are not modified.
    """
    tau, M = next(iter(batches.values())).shape[:2]
    x_prev = state["x_prev_global"]
    lr = float(lr)

    def lesam_pert(x_m):
        """Locally estimated global perturbation (Fan'24): direction of the
        drift from the last round's global model, recomputed at the CURRENT
        local iterate (zero at round start, grows as the worker drifts)."""
        d = tree_map(lambda c, a: c - _f32(a), x_prev, x_m)
        n = torch.sqrt(sum(torch.sum(torch.square(l))
                           for _, l in tree_items(d)))
        return tree_map(lambda l: rho * l / torch.clamp(n, min=eps), d)

    def local_step(x_m, batch_m, c_m=None):
        if method == "fedlesam":
            x_eval = tree_map(lambda a, e: a + e.to(a.dtype), x_m,
                              lesam_pert(x_m))
        else:
            x_eval = x_m
        _, g = value_and_grad(lambda p, b: (loss_fn(p, b), None), x_eval,
                              batch_m)
        if c_m is not None:  # SCAFFOLD correction
            g = tree_map(lambda gg, cm, cc: _f32(gg) - cm + cc,
                         g, c_m, state["c"])
        return tree_map(lambda a, gg: (_f32(a) - lr * _f32(gg)).to(a.dtype),
                        x_m, g)

    workers = []
    for m in range(M):
        x_m = tree_at(stacked, m)
        c_m = tree_at(state["c_m"], m) if method == "scaffold" else None
        for t in range(tau):
            x_m = local_step(x_m, {k: v[t, m] for k, v in batches.items()},
                             c_m)
        workers.append(x_m)
    new = tree_stack(workers)

    # ---- aggregation -------------------------------------------------------
    if dppf is not None and dppf.push:
        new, metrics = pp.pullpush(new, dppf.alpha, float(lam_t), dppf.eps)
    else:  # FedAvg: hard reset to the average
        xa = pp.tree_mean0(new)
        new = tree_map(lambda a, c: c[None].expand(a.shape).to(a.dtype)
                       .contiguous(), new, xa)
        metrics = {"consensus_dist": torch.zeros(
            (), dtype=torch.float32, device=tree_items(new)[0][1].device)}

    state = dict(state)
    # ---- control-variate update (SCAFFOLD option II) ------------------------
    if method == "scaffold":
        # c_m+ = c_m - c + (x_prev - x_m_after_round) / (tau * lr)
        state["c_m"] = tree_map(
            lambda cm, xm, cc, xp: cm - cc[None] + (xp[None] - _f32(xm))
            / (tau * lr), state["c_m"], new, state["c"], x_prev)
        state["c"] = pp.tree_mean0(state["c_m"])
    state["x_prev_global"] = pp.tree_mean0(new)
    return new, state, metrics
