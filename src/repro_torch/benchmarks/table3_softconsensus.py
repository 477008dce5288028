"""Paper Table 3: soft-consensus optimizers (SimpleAvg/EASGD/LSGD/MGRAWA)
with and without the DPPF push mechanism. Reproduces Remark 1: DPPF_LSGD
with push-from-average does not converge; push-from-leader does.

Counterpart of the reference's ``benchmarks/table3_softconsensus.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig

SEEDS = (182, 437)


def run(steps=400, M=4, *, device="cuda"):
    data = default_data(device=device)
    out = {}
    for method in ("simple_avg", "easgd", "lsgd", "mgrawa"):
        for push in (False, True):
            errs = []
            for s in SEEDS:
                d = DPPFConfig(consensus=method, alpha=0.1,
                               lam=0.5 if push else 0.0, tau=4, push=push)
                r = run_distributed(data, d, M=M, steps=steps, seed=s)
                errs.append(r.test_err)
            name = ("DPPF_" if push else "") + method
            out[name] = (float(np.mean(errs)), float(np.std(errs)))
            csv("table3", method=name, test_err=round(out[name][0], 2),
                std=round(out[name][1], 2))
    wins = sum(out[f"DPPF_{m}"][0] <= out[m][0] + 0.3
               for m in ("simple_avg", "easgd", "mgrawa"))
    csv("table3_summary", push_wins_of_3=wins)
    return out


if __name__ == "__main__":
    run()
