"""Paper Table 4: flatness mechanisms at local vs distributed level —
DDP-SGD / DPPF-SGD / DDP-SAM / DPPF-SAM grid.

Counterpart of the reference's ``benchmarks/table4_sam.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import csv, default_data, run_distributed
from repro_torch.configs import DPPFConfig

SEEDS = (182, 437)


def run(steps=400, M=4, *, device="cuda"):
    data = default_data(device=device)
    grid = {
        "DDP_SGD": (DPPFConfig(consensus="ddp"), 0.0),
        "DPPF_SGD": (DPPFConfig(alpha=0.1, lam=0.5, tau=4), 0.0),
        "DDP_SAM": (DPPFConfig(consensus="ddp"), 0.1),
        "DPPF_SAM": (DPPFConfig(alpha=0.1, lam=0.1, tau=4), 0.1),
    }
    out = {}
    for name, (dcfg, rho) in grid.items():
        errs = [run_distributed(data, dcfg, M=M, steps=steps, seed=s,
                                sam_rho=rho).test_err for s in SEEDS]
        out[name] = (float(np.mean(errs)), float(np.std(errs)))
        csv("table4", method=name, test_err=round(out[name][0], 2),
            std=round(out[name][1], 2))
    csv("table4_summary",
        dppf_sgd_vs_ddp_sgd=round(out["DDP_SGD"][0] - out["DPPF_SGD"][0], 2),
        dppf_sam_vs_ddp_sam=round(out["DDP_SAM"][0] - out["DPPF_SAM"][0], 2))
    return out


if __name__ == "__main__":
    run()
