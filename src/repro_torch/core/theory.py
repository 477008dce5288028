"""Theory validation utilities.

Counterpart of ``repro/core/theory.py``. Theorem 1: asymptotic valley
width lam/alpha (+ O(eta*sigma + 1/sqrt(M))). Theorem 3's proof recurrence
is simulated exactly in ``width_recurrence`` (numpy: the reference's bits).
Algorithm 3: 2D landscape scan around x_A via SVD of worker gap vectors
(the Fig. 4/5 visualizations), evaluated on the workers' device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import tree_items
from repro_torch.core.sharpness import _flat, _unflat


def predicted_width(alpha: float, lam: float) -> float:
    """Theorem 1 limit."""
    return lam / alpha


def width_upper_bound(alpha, lam, eta, tau, sigma0, M):
    """Eq. 22 of the proof: the full finite-M, finite-eta bound."""
    beta = eta * (1 - alpha) * np.sqrt(tau) * sigma0 * np.sqrt((M + 1) / M)
    gamma = lam * (1 + 1 / np.sqrt(M))
    return (beta + gamma) / alpha


def width_recurrence(alpha, lam, eta, tau, sigma0, M, d=64, rounds=500,
                     seed=0):
    """Simulate the gap recurrence (proof Eq. 16) on random-walk workers:
    Delta+_{k} = (1-a) Delta+_{k-1} - eta (1-a) Z + lam u_m - lam u_bar.
    Returns the empirical ||Delta+|| trajectory mean over workers."""
    rng = np.random.default_rng(seed)
    delta = np.zeros((M, d))
    traj = []
    for _ in range(rounds):
        # local drift: Z_m = Gbar - G_m with G_m ~ N(0, tau sigma0^2 I)
        G = rng.normal(0.0, sigma0 * np.sqrt(tau), size=(M, d))
        Z = G.mean(0, keepdims=True) - G
        drift = delta - eta * Z
        norms = np.linalg.norm(drift, axis=1, keepdims=True)
        u = np.where(norms > 1e-12, drift / np.maximum(norms, 1e-12),
                     rng.normal(size=(M, d)) / np.sqrt(d))
        u = u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
        delta = (1 - alpha) * drift + lam * u - lam * u.mean(0, keepdims=True)
        # re-center (gap is relative to the average)
        delta = delta - delta.mean(0, keepdims=True)
        traj.append(np.linalg.norm(delta, axis=1).mean())
    return np.asarray(traj)


# ---------------------------------------------------------------------------
# Algorithm 3: landscape visualization scan
# ---------------------------------------------------------------------------

def landscape_scan(eval_fn, workers, *, lim=1.0, step=0.25):
    """Algorithm 3. eval_fn(params) -> scalar (loss or error %), evaluated
    on the workers' device (the SVD runs in numpy on the host).

    Returns dict with the grid, the 2D scan values, and each worker's
    projected coordinates on the SVD plane centered at x_A. Needs two
    workers or more: the plane is spanned by the gap matrix's top two
    right singular vectors. (The reference's one-worker fallback parses as
    ``v2 = vt[1] if ... else (vt[0], vt[0])`` and fails on a shape error.)
    """
    M = len(workers)
    if M < 2:
        raise ValueError(f"landscape_scan needs at least 2 workers, got {M}: "
                         "one worker spans no plane")
    template = workers[0]
    device = tree_items(template)[0][1].device
    flats = np.stack([_flat(w).cpu().numpy() for w in workers])
    x_a = flats.mean(0)
    gaps = flats - x_a[None]
    # top-2 right singular vectors of the gap matrix
    _, _, vt = np.linalg.svd(gaps, full_matrices=False)
    v1, v2 = vt[0], vt[1]
    coords = np.stack([gaps @ v1, gaps @ v2], axis=1)  # (M, 2)

    grid = np.arange(-lim, lim + step / 2, step)
    scan = np.zeros((len(grid), len(grid)))
    with torch.no_grad():
        for i, a in enumerate(grid):
            for j, b in enumerate(grid):
                p = _unflat(torch.as_tensor(x_a + a * v1 + b * v2,
                                            device=device), template)
                scan[i, j] = float(eval_fn(p))
    return {"grid": grid, "scan": scan, "worker_coords": coords,
            "dirs": (v1, v2)}
