"""Shared harness for the paper-table benchmarks.

Counterpart of the reference's top-level ``benchmarks/common.py``: an MLP
classifier on Gaussian-cluster data with label noise (overfits -> visible
generalization gaps), trained with the SAME distributed trainer the big
architectures use. Every paper table maps to one module here; the
qualitative orderings (DPPF vs baselines) are the reproduction target.

Everything runs where the data lies: ``default_data()`` puts it on the
card, ``default_data(device="cpu")`` on the CPU. The MLP's initial weights
come from a ``torch.Generator`` seeded with the run's seed (drawn on the
CPU, then moved), so they differ from the reference's ``jax.random``
draws; ``mlp_params_from_numpy`` carries the reference's weights across.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import DPPFConfig
from repro_torch.core import pullpush as pp
from repro_torch.core.engine import tree_map
from repro_torch.data import classification_task
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    RoundClock, TrainState, average_params, init_train_state, make_ddp_step,
    make_round_step, stacked_params,
)


# ---------------------------------------------------------------------------
# Small model
# ---------------------------------------------------------------------------

def mlp_init(gen, dim, n_classes, width=64, depth=2, *, device):
    """``{"l<i>": {"w": (in, out), "b": (out,)}}``: normal weights scaled
    by fan-in^-0.5 (drawn from the CPU generator ``gen`` in layer order),
    zero biases."""
    sizes = [dim] + [width] * depth + [n_classes]
    return {f"l{i}": {
        "w": (torch.randn((sizes[i], sizes[i + 1]), generator=gen)
              * sizes[i] ** -0.5).to(device),
        "b": torch.zeros((sizes[i + 1],), device=device),
    } for i in range(depth + 1)}


def mlp_params_from_numpy(tree, *, device):
    """A parameter tree of numpy arrays (e.g. the reference's ``mlp_init``
    output through ``np.asarray``) as the port's tree on ``device``."""
    return {l: {k: torch.tensor(np.asarray(v), device=device)
                for k, v in d.items()} for l, d in tree.items()}


def mlp_logits(params, x):
    n = len(params)
    for i in range(n):
        x = x @ params[f"l{i}"]["w"] + params[f"l{i}"]["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params, batch):
    logits = mlp_logits(params, batch["x"])
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, batch["y"][:, None])[:, 0]
    loss = torch.mean(lse - picked)
    return loss, {"loss": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


def error_pct(params, x, y):
    """Top-1 error in percent (``argmax`` takes the first of tied
    logits)."""
    with torch.no_grad():
        pred = torch.argmax(mlp_logits(params, x), dim=-1)
        return float(100.0 * torch.mean((pred != y).to(torch.float32)))


# ---------------------------------------------------------------------------
# Data plumbing
# ---------------------------------------------------------------------------

def worker_shards(n, M, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return np.array_split(idx, M)


def train_rows(data, idx):
    """``{"x", "y"}``: the train rows at the numpy indices ``idx`` (any
    shape), gathered where the data lies; labels int64."""
    it = torch.from_numpy(np.asarray(idx)).to(data["x_train"].device)
    return {"x": data["x_train"][it],
            "y": data["y_train"][it].to(torch.int64)}


def round_batches(data, shards, rng, tau, M, bs):
    """``{"x": (tau, M, bs, dim), "y": (tau, M, bs)}`` on the data's
    device. The numpy draws are the reference's, in its order."""
    return train_rows(data, np.stack([
        np.stack([rng.choice(shards[m], size=bs, replace=False)
                  for m in range(M)]) for _ in range(tau)]))


# ---------------------------------------------------------------------------
# Training drivers
# ---------------------------------------------------------------------------

@dataclass
class RunResult:
    test_err: float
    train_err: float
    gen_gap: float
    comm_pct: float          # communication volume vs DDP (100 = per-step)
    consensus_dist: float
    history: dict
    params_avg: object
    workers: list            # per-worker param trees (for MV measure)
    seconds: float


def run_distributed(data, dcfg: DPPFConfig, *, M=4, bs=64, steps=400,
                    lr=0.05, momentum=0.9, wd=1e-3, sam_rho=0.0, width=64,
                    seed=0, qsr_eta_max=None, track_every=0):
    """Train with the shared trainer on the data's device; returns
    RunResult. ``dcfg.consensus == 'ddp'`` uses the per-step
    gradient-averaging path."""
    device = data["x_train"].device
    gen = torch.Generator().manual_seed(seed)
    opt = make_optimizer("sgd", momentum=momentum, weight_decay=wd)
    p0 = lambda g, dev: mlp_init(g, data["dim"], data["n_classes"], width,
                                 device=dev)
    shards = worker_shards(len(data["x_train"]), M, seed)
    rng = np.random.default_rng(seed + 1)
    t0 = time.time()
    history = {"consensus_dist": [], "step": [], "pull": [], "push": [],
               "lam": []}

    if dcfg.consensus == "ddp":
        params = p0(gen, device)
        state = TrainState(params=params, opt=opt.init(params), cstate={})
        step_fn = make_ddp_step(mlp_loss, opt, base_lr=lr, total_steps=steps,
                                sam_rho=sam_rho)
        for _ in range(steps):
            b = round_batches(data, shards, rng, 1, M, bs)
            state, _ = step_fn(state, {k: v[0] for k, v in b.items()})
        avg = state.params
        workers = [state.params]
        comm_pct, cdist = 100.0, 0.0
    else:
        state = init_train_state(p0, opt, dcfg, M, gen, device=device)
        # the RoundClock owns the round plan (fixed / remainder /
        # QSR-adaptive taus) and both schedules
        clock = RoundClock.from_config(dcfg, base_lr=lr, total_steps=steps)
        step_fn = make_round_step(mlp_loss, opt, dcfg, clock=clock,
                                  sam_rho=sam_rho)
        for spec in clock.rounds:
            b = round_batches(data, shards, rng, spec.tau, M, bs)
            state, m = step_fn(state, b)
            if track_every and ((spec.index + 1) % track_every == 0):
                history["consensus_dist"].append(float(m["consensus_dist"]))
                history["pull"].append(float(m.get("pull_force", 0.0)))
                history["push"].append(float(m.get("push_force", 0.0)))
                history["lam"].append(float(m.get("lam_t", 0.0)))
                history["step"].append(spec.stop)
        avg = average_params(state)
        stacked = stacked_params(state)   # tree view whichever engine ran
        workers = [tree_map(lambda a, i=i: a[i].clone(), stacked)
                   for i in range(M)]
        comm_pct = 100.0 * clock.total_rounds / steps
        cdist = float(pp.worker_dists(stacked).mean())

    train_err = error_pct(avg, data["x_train"], data["y_train"])
    test_err = error_pct(avg, data["x_test"], data["y_test"])
    return RunResult(test_err=test_err, train_err=train_err,
                     gen_gap=test_err - train_err, comm_pct=comm_pct,
                     consensus_dist=cdist, history=history, params_avg=avg,
                     workers=workers, seconds=time.time() - t0)


def default_data(seed=0, *, device="cuda", **kw):
    return classification_task(seed=seed, device=device, **kw)


def csv(name, **kv):
    print(name + "," + ",".join(f"{k}={v}" for k, v in kv.items()), flush=True)
