"""Paper Figure 2 + 3 (§8.1): valley collapse without the push force, and
the pull/push tug-of-war. Weak pulls alone cannot keep workers apart; DPPF
stabilizes the consensus distance near lambda/alpha (Theorem 1).

Counterpart of the reference's ``benchmarks/fig2_valley_collapse.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig


def run(steps=600, M=4, *, device="cuda"):
    data = default_data(device=device)
    rows = {}
    for alpha in (0.0001, 0.005, 0.01, 0.05):
        r = run_distributed(
            data, DPPFConfig(consensus="simple_avg", alpha=alpha, lam=0.0,
                             push=False, tau=4),
            M=M, steps=steps, track_every=5)
        rows[f"pull_only(alpha={alpha})"] = r
    dppf = run_distributed(
        data, DPPFConfig(consensus="simple_avg", alpha=0.1, lam=0.5,
                         push=True, tau=4, lam_schedule="fixed"),
        M=M, steps=steps, track_every=5)
    rows["DPPF(a=0.1,l=0.5)"] = dppf

    for name, r in rows.items():
        h = r.history["consensus_dist"]
        early = float(np.mean(h[:3])) if h else 0.0
        csv("fig2", method=name, final_dist=round(r.consensus_dist, 4),
            early_dist=round(early, 4),
            collapsing=bool(r.consensus_dist < 0.5 * max(early, 1e-9)),
            test_err=round(r.test_err, 2))
    # tug-of-war phases (Fig 3): pull force alpha*dist vs push force lam
    h = dppf.history
    if h["step"]:
        csv("fig3", early_pull=round(h["pull"][0], 4),
            early_push=round(h["push"][0], 4),
            late_pull=round(h["pull"][-1], 4),
            late_push=round(h["push"][-1], 4),
            final_ratio_dist_over_lam_alpha=round(
                dppf.consensus_dist / (0.5 / 0.1), 3))
    return rows


if __name__ == "__main__":
    run()
