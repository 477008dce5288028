"""Paper §D.2: empirical support for Theorem 2's assumptions and claim.

(a) sensitivity of test error to lambda at fixed alpha (Fig. 8a shape:
    too-narrow and too-wide valleys are suboptimal, broad sweet spot);
(b) ||x_A||_2 grows with lambda (the bounded-drift assumption
    ||mu_r||^2 <= D0 r^beta with beta < 1 — Fig. 9a);
(c) width/norm ratio grows with lambda (Fig. 9b).

Counterpart of the reference's ``benchmarks/d2_theorem2.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig
from repro_torch.core.engine import tree_items


def run(steps=400, M=4, alpha=0.5, *, device="cuda"):
    data = default_data(device=device)
    rows = []
    for lam in (0.1, 0.5, 1.0, 2.5, 5.0, 10.0):
        r = run_distributed(
            data, DPPFConfig(alpha=alpha, lam=lam, tau=4,
                             lam_schedule="fixed"),
            M=M, steps=steps)
        flat = torch.cat([l.reshape(-1) for _, l in
                          tree_items(r.params_avg)])
        norm = float(torch.linalg.vector_norm(flat))
        rows.append((lam, r.test_err, r.consensus_dist, norm))
        csv("d2_theorem2", alpha=alpha, lam=lam,
            test_err=round(r.test_err, 2),
            width=round(r.consensus_dist, 3),
            xa_norm=round(norm, 3),
            width_over_norm=round(r.consensus_dist / norm, 4))
    # assumption checks
    norms = [n for (_, _, _, n) in rows]
    ratios = [w / n for (_, _, w, n) in rows]
    csv("d2_summary",
        xa_norm_monotone_up=bool(all(b >= a - 1e-3 for a, b in
                                     zip(norms, norms[1:]))),
        ratio_monotone_up=bool(all(b >= a - 1e-3 for a, b in
                                   zip(ratios, ratios[1:]))),
        best_lam=rows[int(np.argmin([e for (_, e, _, _) in rows]))][0])
    return rows


if __name__ == "__main__":
    run()
