"""Schedules: push strength lambda (paper §C.2), QSR communication period
(Gu et al. 2024, §7.2), and cosine LR.

Counterpart of ``repro/core/schedules.py``. The JAX schedules are traced
fp32 scalars; PyTorch runs eagerly, so these are host functions that do
the same arithmetic in numpy float32 and return a python float.
"""
from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def lam_schedule(kind: str, lam: float, t, T):
    """Paper §C.2. t: current iteration, T: total iterations.
    increasing (the paper's default for main results): flipped cosine."""
    frac = np.clip(_F32(t) / _F32(max(T, 1)), _F32(0.0), _F32(1.0))
    if kind == "fixed":
        return float(_F32(lam))
    if kind == "decreasing":
        return float(_F32(lam) / _F32(2.0)
                     * (_F32(1.0) + np.cos(frac * _F32(math.pi))))
    if kind == "increasing":
        return float(_F32(lam) / _F32(2.0)
                     * (_F32(1.0) - np.cos(frac * _F32(math.pi))))
    raise ValueError(kind)


def qsr_tau(eta_t: float, tau_base: int, beta: float) -> int:
    """Quadratic Synchronization Rule: tau_t = max(tau_base, floor((beta/eta)^2))."""
    if eta_t <= 0:
        return tau_base
    return max(tau_base, int((beta / eta_t) ** 2))


def cosine_lr(base_lr: float, t, T, warmup: int = 0):
    t = _F32(t)
    if t < warmup:
        return float(_F32(base_lr) * t / _F32(max(warmup, 1)))
    frac = np.clip((t - _F32(warmup)) / _F32(max(T - warmup, 1)),
                   _F32(0.0), _F32(1.0))
    return float(_F32(base_lr) / _F32(2.0)
                 * (_F32(1.0) + np.cos(frac * _F32(math.pi))))
