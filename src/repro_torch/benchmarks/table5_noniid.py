"""Paper Table 5 / §8.3: non-IID FL — SCAFFOLD and FedLESAM with and
without the DPPF aggregation, under Dirichlet(0.1 / 0.6) splits.

Plus the heterogeneous-worker METHOD ZOO (``run_zoo`` / the ``method_zoo``
suite): every registered consensus method from ``core.methods`` trained by
the shared flat-engine trainer under per-worker label skew
(Dirichlet-partitioned shards) and speed skew (slow workers refresh their
batch less often inside a round, so a fraction of their tau local steps
recompute a stale gradient), recording test error, generalization gap,
consensus distance, and the Mean Valley width (paper Alg. 2) per method.

Counterpart of the reference's ``benchmarks/table5_noniid.py``. The zoo's
JSON is written only where ``out_json`` names a path: the committed
``results/method_zoo.json`` is the reference's."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import (
    csv, default_data, error_pct, mlp_loss, train_rows,
)
from repro_torch.configs import DPPFConfig
from repro_torch.core import fl
from repro_torch.core import pullpush as pp
from repro_torch.core.engine import tree_map
from repro_torch.core.methods import get_method, method_names
from repro_torch.core.schedules import lam_schedule
from repro_torch.core.valley import mean_valley
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    RoundClock, TrainState, average_params, init_train_state, make_ddp_step,
    make_round_step, stacked_params,
)

SEEDS = (182, 437)


def _loss(params, batch):
    return mlp_loss(params, batch)[0]


def run_fl_training(data, method, *, dppf=None, M=4, tau=16, rounds=25,
                    bs=64, lr=0.25, dir_alpha=0.6, seed=0):
    device = data["x_train"].device
    shards = fl.dirichlet_partition(data["y_train"], M, dir_alpha, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    p0 = common.mlp_init(gen, data["dim"], data["n_classes"], device=device)
    stacked = tree_map(
        lambda a: a[None].expand((M,) + a.shape).contiguous(), p0)
    state = fl.init_fl_state(method, stacked)
    rng = np.random.default_rng(seed + 5)

    for r in range(rounds):
        # one index draw per (t, m) so features and labels correspond
        idx = np.stack([[rng.choice(shards[m], bs) for m in range(M)]
                        for _ in range(tau)])
        lam = (float(lam_schedule(dppf.lam_schedule, dppf.lam, r, rounds))
               if dppf else 0.0)
        stacked, state, _ = fl.fl_round(method, _loss, stacked, state,
                                        train_rows(data, idx), lr, dppf=dppf,
                                        lam_t=lam)
    avg = tree_map(lambda a: torch.mean(a, dim=0), stacked)
    return error_pct(avg, data["x_test"], data["y_test"])


def run(rounds=25, M=4, *, device="cuda"):
    data = default_data(device=device)
    out = {}
    for dir_alpha in (0.1, 0.6):
        for method in ("scaffold", "fedlesam"):
            for use_dppf in (False, True):
                # paper C.3: lam=1.8 for SCAFFOLD; conservative lam for
                # FedLESAM (two flatness mechanisms compose)
                lam = 1.8 if method == "scaffold" else 0.6
                dcfg = (DPPFConfig(alpha=0.9, lam=lam, tau=16)
                        if use_dppf else None)
                errs = [run_fl_training(data, method, dppf=dcfg, M=M,
                                        rounds=rounds, dir_alpha=dir_alpha,
                                        seed=s) for s in SEEDS]
                name = ("DPPF_" if use_dppf else "") + method
                key = f"{name}@dir{dir_alpha}"
                out[key] = (float(np.mean(errs)), float(np.std(errs)))
                csv("table5", method=name, dirichlet=dir_alpha,
                    test_err=round(out[key][0], 2),
                    std=round(out[key][1], 2))
    wins = sum(out[f"DPPF_{m}@dir{d}"][0] <= out[f"{m}@dir{d}"][0] + 0.3
               for m in ("scaffold", "fedlesam") for d in (0.1, 0.6))
    csv("table5_summary", dppf_wins_of_4=wins)
    return out


# ---------------------------------------------------------------------------
# Heterogeneous-worker method zoo
# ---------------------------------------------------------------------------

ZOO_SPEEDS = (1.0, 1.0, 0.5, 0.25)   # per-worker speed skew (fresh-batch rate)


def _zoo_batches(data, shards, rng, tau, bs, speeds):
    """One round of per-worker batches under label + speed skew: worker m
    draws from ITS Dirichlet shard, and only refreshes its batch on
    ``ceil(t / (1/speed))`` boundaries — a speed-s worker computes
    ``round(tau * s)`` fresh gradients per round and replays its last
    batch for the rest (the stale-compute model of a straggler that
    cannot keep the fleet's step cadence)."""
    M = len(speeds)
    idx = np.empty((tau, M, bs), np.int64)
    for m, s in enumerate(speeds):
        fresh = max(1, int(round(tau * s)))
        picks = [rng.choice(shards[m], size=bs, replace=False)
                 for _ in range(fresh)]
        for t in range(tau):
            idx[t, m] = picks[min(t * fresh // tau, fresh - 1)]
    return train_rows(data, idx)


def _zoo_config(method):
    """Per-method DPPFConfig: the shared pull/push operating point from
    the table-3 soft-consensus grid; method-specific behavior (hard's
    alpha := 1, parle's ramp, lpf_sgd's filtered push, entropy_sgd's
    inner plan) comes from the registry spec, not per-method tuning."""
    spec = get_method(method)
    if not spec.communicates:
        return DPPFConfig(consensus=method)
    return DPPFConfig(consensus=method, alpha=0.1, lam=0.5, tau=4,
                      engine="flat")


def _zoo_train(data, method, shards, *, steps, bs, lr, speeds, seed):
    M = len(speeds)
    device = data["x_train"].device
    dcfg = _zoo_config(method)
    gen = torch.Generator().manual_seed(seed)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    p0 = lambda g, dev: common.mlp_init(g, data["dim"], data["n_classes"],
                                        device=dev)
    rng = np.random.default_rng(seed + 1)

    if not get_method(method).communicates:          # ddp: per-step path
        params = p0(gen, device)
        state = TrainState(params=params, opt=opt.init(params), cstate={})
        step_fn = make_ddp_step(mlp_loss, opt, base_lr=lr, total_steps=steps)
        tau = 4
        for _ in range(steps // tau):
            b = _zoo_batches(data, shards, rng, tau, bs, speeds)
            for t in range(tau):
                state, _ = step_fn(state, {k: v[t] for k, v in b.items()})
        return state.params, None, 0.0

    state = init_train_state(p0, opt, dcfg, M, gen, device=device)
    clock = RoundClock.from_config(dcfg, base_lr=lr, total_steps=steps)
    step_fn = make_round_step(mlp_loss, opt, dcfg, clock=clock)
    for spec in clock.rounds:
        b = _zoo_batches(data, shards, rng, spec.tau, bs, speeds)
        state, _ = step_fn(state, b)
    avg = average_params(state)
    stacked = stacked_params(state)
    workers = [tree_map(lambda a, i=i: a[i].clone(), stacked)
               for i in range(M)]
    cdist = float(pp.worker_dists(stacked).mean())
    return avg, workers, cdist


def run_zoo(steps=240, bs=48, lr=0.05, dir_alpha=0.3, speeds=ZOO_SPEEDS,
            seed=0, out_json="", *, device="cuda"):
    """The full registered-method zoo under label + speed skew. One row
    per canonical method; ``mean_valley`` is the paper's Alg. 2 width
    from the average point along each worker direction (None for ddp —
    a single model has no worker spread to measure). ``out_json``: a path
    (relative to the working directory) to write the rows to, or ""."""
    data = default_data(device=device)
    M = len(speeds)
    shards = fl.dirichlet_partition(data["y_train"], M, dir_alpha, seed=seed)
    full = {"x": data["x_train"], "y": data["y_train"].to(torch.int64)}
    loss_on_train = lambda p: mlp_loss(p, full)[0]
    out = {"config": {"steps": steps, "bs": bs, "lr": lr,
                      "dir_alpha": dir_alpha, "speeds": list(speeds),
                      "workers": M, "seed": seed},
           "methods": {}}
    for method in method_names(aliases=False):
        avg, workers, cdist = _zoo_train(
            data, method, shards, steps=steps, bs=bs, lr=lr,
            speeds=speeds, seed=seed)
        test_err = error_pct(avg, data["x_test"], data["y_test"])
        train_err = error_pct(avg, data["x_train"], data["y_train"])
        mv = None
        if workers is not None and len(workers) > 1:
            mv = mean_valley(loss_on_train, workers, kappa=2.0, step=0.05,
                             max_steps=120)["mv"]
        row = {"test_err": round(test_err, 2),
               "gen_gap": round(test_err - train_err, 2),
               "consensus_dist": round(cdist, 4),
               "mean_valley": round(mv, 4) if mv is not None else None,
               "flags": get_method(method).flags}
        out["methods"][method] = row
        csv("method_zoo", method=method, **{
            k: v for k, v in row.items() if k != "flags"})
    if out_json:
        path = os.path.abspath(out_json)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}")
    return out


if __name__ == "__main__":
    run()
    run_zoo()
