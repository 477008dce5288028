"""Paper Table 2 / Figure 1: communication volume vs test error.
DDP vs LocalSGD(tau) vs LocalSGD+QSR vs DPPF(tau).

Counterpart of the reference's ``benchmarks/table2_comm.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig

SEEDS = (182, 437)


def _avg(results):
    return (float(np.mean([r.test_err for r in results])),
            float(np.std([r.test_err for r in results])),
            float(np.mean([r.comm_pct for r in results])))


def run(steps=400, M=4, *, device="cuda"):
    data = default_data(device=device)
    rows = []

    def several(dcfg, **kw):
        return [run_distributed(data, dcfg, M=M, steps=steps, seed=s, **kw)
                for s in SEEDS]

    rows.append(("DDP-SGD", _avg(several(DPPFConfig(consensus="ddp")))))
    for tau in (4, 8, 16):
        rows.append((f"LocalSGD(tau={tau})", _avg(several(
            DPPFConfig(consensus="hard", tau=tau, push=False)))))
    for tb in (2, 4):
        rows.append((f"QSR(tau_base={tb})", _avg(several(
            DPPFConfig(consensus="hard", tau=tb, push=False,
                       qsr_beta=0.015)))))
    for tau in (4, 8, 16):
        rows.append((f"DPPF(tau={tau})", _avg(several(
            DPPFConfig(consensus="simple_avg", alpha=0.1, lam=0.5, tau=tau,
                       push=True)))))

    best_base = min(r[1][0] for r in rows[:6])
    for name, (err, std, comm) in rows:
        csv("table2", method=name, test_err=round(err, 2),
            std=round(std, 2), comm_pct=round(comm, 1))
    dppf_best = min(r[1][0] for r in rows[6:])
    csv("table2_summary", dppf_best=round(dppf_best, 2),
        baseline_best=round(best_base, 2),
        dppf_beats_baselines=bool(dppf_best <= best_base + 0.25))
    return rows


if __name__ == "__main__":
    run()
