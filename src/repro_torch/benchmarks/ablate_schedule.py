"""Paper §C.2: lambda-schedule ablation (fixed / increasing / decreasing),
plus the §7.2 round-clock row: QSR-adaptive tau on top of the best lambda
schedule (fewer consensus all-reduces at matching test error).

Counterpart of the reference's ``benchmarks/ablate_schedule.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig

SEEDS = (42, 182, 437)
QSR_BETA = 0.05   # with lr=0.05 cosine: tau stays 4 early, grows as lr decays


def run(steps=400, M=4, *, device="cuda"):
    data = default_data(device=device)
    out = {}
    for sched in ("fixed", "increasing", "decreasing"):
        errs = [run_distributed(
            data, DPPFConfig(alpha=0.1, lam=0.5, tau=4, lam_schedule=sched),
            M=M, steps=steps, seed=s).test_err for s in SEEDS]
        out[sched] = (float(np.mean(errs)), float(np.std(errs)))
        csv("ablate_schedule", schedule=sched,
            test_err=round(out[sched][0], 2), std=round(out[sched][1], 2))
    # round-clock row: adaptive communication period (QSR) on the paper's
    # main-results lambda schedule — report comm volume next to error
    runs = [run_distributed(
        data, DPPFConfig(alpha=0.1, lam=0.5, tau=4,
                         lam_schedule="increasing", tau_schedule="qsr",
                         qsr_beta=QSR_BETA),
        M=M, steps=steps, seed=s) for s in SEEDS]
    errs = [r.test_err for r in runs]
    out["increasing+qsr"] = (float(np.mean(errs)), float(np.std(errs)))
    csv("ablate_schedule", schedule="increasing+qsr",
        test_err=round(out["increasing+qsr"][0], 2),
        std=round(out["increasing+qsr"][1], 2),
        comm_pct=round(float(np.mean([r.comm_pct for r in runs])), 1))
    best = min(out, key=lambda k: out[k][0])
    csv("ablate_schedule_summary", best=best)
    return out


if __name__ == "__main__":
    run()
