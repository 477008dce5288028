"""Worker-count scaling (the 4-worker/8-worker axis of paper Tables 3/4):
does the push mechanism keep its edge as M grows, and does the final width
stay at lambda/alpha independent of M (Theorem 1's M-robustness)?

Counterpart of the reference's ``benchmarks/ablate_workers.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig

SEEDS = (182, 437)


def run(steps=400, *, device="cuda"):
    data = default_data(device=device)
    for M in (2, 4, 8):
        for name, dcfg in (
            ("SimpleAvg", DPPFConfig(alpha=0.1, lam=0.0, push=False, tau=4)),
            ("DPPF", DPPFConfig(alpha=0.1, lam=0.5, tau=4)),
        ):
            errs, widths = [], []
            for s in SEEDS:
                r = run_distributed(data, dcfg, M=M, steps=steps, seed=s)
                errs.append(r.test_err)
                widths.append(r.consensus_dist)
            csv("ablate_workers", M=M, method=name,
                test_err=round(float(np.mean(errs)), 2),
                std=round(float(np.std(errs)), 2),
                width=round(float(np.mean(widths)), 3))


if __name__ == "__main__":
    run()
