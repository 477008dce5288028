"""Theorem 1 validation: the asymptotic valley width E||Delta+|| converges
to lambda/alpha, on (a) the exact proof recurrence and (b) real DNN training
with the DPPF trainer, across a (lambda, alpha, M) grid.

Counterpart of the reference's ``benchmarks/theorem1_width.py``."""
from __future__ import annotations

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig
from repro_torch.core.theory import predicted_width, width_recurrence


def run(steps=600, *, device="cuda"):
    # (a) exact recurrence from the proof (Eq. 16)
    for (alpha, lam, M) in [(0.1, 0.5, 4), (0.1, 0.5, 32), (0.5, 2.5, 8),
                            (0.2, 0.2, 8)]:
        traj = width_recurrence(alpha, lam, eta=0.01, tau=4, sigma0=1.0, M=M,
                                rounds=400)
        emp = float(traj[-50:].mean())
        pred = predicted_width(alpha, lam)
        csv("theorem1_recurrence", alpha=alpha, lam=lam, M=M,
            predicted=pred, empirical=round(emp, 3),
            rel_err=round(abs(emp - pred) / pred, 3))

    # (b) real training
    data = default_data(device=device)
    for (alpha, lam) in [(0.1, 0.5), (0.1, 1.0), (0.5, 2.5)]:
        r = run_distributed(
            data, DPPFConfig(alpha=alpha, lam=lam, tau=4,
                             lam_schedule="fixed"),
            M=8, steps=steps)
        pred = predicted_width(alpha, lam)
        csv("theorem1_training", alpha=alpha, lam=lam, predicted=pred,
            empirical=round(r.consensus_dist, 3),
            rel_err=round(abs(r.consensus_dist - pred) / pred, 3))


if __name__ == "__main__":
    run()
