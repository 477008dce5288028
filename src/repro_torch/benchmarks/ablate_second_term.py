"""Paper §D.1 / Figure 7: is the dropped second term T2 (mean unit
direction) really negligible? We track ||T1||, ||T2||, ||T1+T2|| at the
final point of DPPF training and compare final errors of simplified vs
exact updates.

Counterpart of the reference's ``benchmarks/ablate_second_term.py``."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig
from repro_torch.core import pullpush as pp
from repro_torch.core.engine import tree_stack


def run(steps=400, M=4, *, device="cuda"):
    data = default_data(device=device)
    r_simple = run_distributed(
        data, DPPFConfig(alpha=0.1, lam=0.5, tau=4), M=M, steps=steps)
    r_exact = run_distributed(
        data, DPPFConfig(alpha=0.1, lam=0.5, tau=4, exact_second_term=True),
        M=M, steps=steps)
    # term norms at the final point
    stacked = tree_stack(r_simple.workers)
    n1, n2, n12 = pp.push_terms_norms(stacked, lam_r=0.5 * M)
    t1 = float(torch.mean(n1))
    csv("ablate_second_term",
        t1_norm=round(t1, 4),
        t2_norm=round(float(n2), 4),
        t1_plus_t2_norm=round(float(torch.mean(n12)), 4),
        err_simplified=round(r_simple.test_err, 2),
        err_exact=round(r_exact.test_err, 2),
        t2_negligible=bool(float(n2) < 0.5 * t1))


if __name__ == "__main__":
    run()
