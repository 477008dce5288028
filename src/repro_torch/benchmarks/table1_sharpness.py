"""Paper Table 1 / §4.1: Kendall rank correlation between sharpness
measures and the generalization gap. Minima of varied quality are produced
by sweeping lr / weight decay / batch size / width (paper B.1), for both
single-worker and EASGD-distributed training; Inv. MV is computed from the
EASGD worker spread (it needs multiple workers — 'NA' for single, as in the
paper).

Counterpart of the reference's ``benchmarks/table1_sharpness.py``. The
measures' random vectors come from a CPU ``torch.Generator`` seeded with
the combination's index, where the reference uses ``PRNGKey(i)``."""
from __future__ import annotations

import itertools

import torch

from repro_torch.benchmarks.common import (
    csv, default_data, mlp_loss, run_distributed,
)
from repro_torch.configs import DPPFConfig
from repro_torch.core import sharpness as sh
from repro_torch.core.valley import mean_valley

GRID = {
    "lr": [0.02, 0.1],
    "wd": [0.0, 1e-3],
    "bs": [16, 128],
    "width": [32, 96],
}


def _full_batch(data, n=1024):
    return {"x": data["x_train"][:n], "y": data["y_train"][:n]}


def run(steps=300, M=4, kappa=2.0, *, device="cuda"):
    data = default_data(noise=1.1, device=device)
    fb = _full_batch(data)
    loss_fn = lambda p, b: mlp_loss(p, b)[0]
    loss_on_train = lambda p: mlp_loss(p, fb)[0]
    gen = lambda i: torch.Generator().manual_seed(i)

    for mode in ("single", "easgd"):
        gaps, measures = [], {k: [] for k in
                              ("eps_sharp", "fisher_rao", "lpf", "lam_max",
                               "trace", "frob", "inv_mv")}
        combos = list(itertools.product(*GRID.values()))
        for i, (lr, wd, bs, width) in enumerate(combos):
            if mode == "single":
                dcfg = DPPFConfig(consensus="ddp")
                r = run_distributed(data, dcfg, M=1, bs=bs, steps=steps,
                                    lr=lr, wd=wd, width=width, seed=i)
            else:
                dcfg = DPPFConfig(consensus="easgd", alpha=0.1, lam=0.0,
                                  push=False, tau=4)
                r = run_distributed(data, dcfg, M=M, bs=bs, steps=steps,
                                    lr=lr, wd=wd, width=width, seed=i)
            if r.train_err > 40.0:
                continue  # paper discards non-fit models
            gaps.append(r.gen_gap)
            p = r.params_avg
            measures["eps_sharp"].append(sh.eps_sharpness(loss_fn, p, fb))
            measures["fisher_rao"].append(sh.fisher_rao(loss_fn, p, fb))
            measures["lpf"].append(sh.lpf(loss_fn, p, fb, gen(i), mcmc=10))
            hm = sh.hessian_measures(loss_fn, p, fb, gen(i), lanczos_iters=10,
                                     hutchinson=4)
            measures["lam_max"].append(hm["lambda_max"])
            measures["trace"].append(hm["trace"])
            measures["frob"].append(hm["frob"])
            if mode == "easgd":
                mv = mean_valley(loss_on_train, r.workers, kappa=kappa,
                                 step=0.05, max_steps=120)
                measures["inv_mv"].append(mv["inv_mv"])

        for name, vals in measures.items():
            if not vals:
                csv("table1", mode=mode, measure=name, kendall="NA")
                continue
            tau = sh.kendall_tau(vals, gaps)
            csv("table1", mode=mode, measure=name, kendall=round(tau, 3),
                n=len(vals))


if __name__ == "__main__":
    run()
