"""DPPF trainer: one communication ROUND is tau purely-local optimizer steps
per worker followed by the consensus pull-push update.

Counterpart of ``repro/train/trainer.py`` for the flat engine with
``overlap="none"``. The worker parameters live in the ConsensusEngine's
persistent ``(R, n)`` fp32 view for the whole run: ``init_train_state``
builds it once, each local step differentiates through ``torch.split``
views of one worker row (``engine.unflatten_row``, cast to the model's
dtype), and the optimizer updates that row and its momentum in place —
the port's counterpart of ``jax.jit(round_step, donate_argnums=0)``. The
consensus stage then runs on the same view (in place on the kernel path).

Local steps loop over worker rows, so one worker's gradient is alive at a
time; this loop is the counterpart of the reference's ``jax.vmap`` over
workers (``_scan_local_steps``), and the loop over steps that of its
``lax.scan``. Batched over workers, the gradients of all M would be alive
at once (19.5 GB more for yi-6b at 4 layers).

The tree engine, the DDP step, the sharded round and the overlap modes are
not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import DPPFConfig
from repro_torch.core import consensus
from repro_torch.core.engine import (
    ConsensusEngine, tree_from_items, tree_items,
)
from repro_torch.core.methods import get_method
from repro_torch.optim import Optimizer, sam_gradient, value_and_grad
from repro_torch.optim.optimizers import worker_state
from repro_torch.train.clock import RoundClock


@dataclass
class TrainState:
    params: Any          # the engine's (R, n) flat view
    opt: Any             # optimizer state over the (M, n) worker rows
    cstate: Any          # consensus state (LPF-SGD's g_ema)
    t: int = 0           # local-step counter
    snap: Any = None     # overlap carry (not ported: always None)
    round: int = 0       # round counter — the clock position
    engine: Any = None   # ConsensusEngine


def _not_ported(what):
    return NotImplementedError(f"not yet ported: {what}")


def init_train_state(loss_params_init, opt: Optimizer, dcfg: DPPFConfig,
                     n_workers: int, gen, *, device, same_init=True,
                     engine=None):
    """Build the flat view from ``loss_params_init(gen, device)``. The paper
    initializes all workers from the same random model (Alg. 1);
    ``same_init=False`` draws one model per worker from ``gen``."""
    if dcfg.engine != "flat":
        raise _not_ported("the tree engine (engine='tree')")
    if not get_method(dcfg.consensus).communicates:
        raise _not_ported(f"{dcfg.consensus} (the DDP step)")
    if dcfg.overlap != "none":
        raise _not_ported(f"overlap={dcfg.overlap!r}")
    if same_init:
        # broadcast views: flatten copies each leaf straight into the view
        stacked = tree_from_items([
            (path, leaf.unsqueeze(0).expand((n_workers,) + leaf.shape))
            for path, leaf in tree_items(loss_params_init(gen, device))])
    else:
        models = [tree_items(loss_params_init(gen, device))
                  for _ in range(n_workers)]
        stacked = tree_from_items([
            (path, torch.stack([m[i][1] for m in models]))
            for i, (path, _) in enumerate(models[0])])
    if engine is None:
        engine = ConsensusEngine.from_stacked(
            stacked, method=dcfg.consensus, eps=dcfg.eps)
    params = engine.flatten(stacked)              # the ONE flatten per run
    del stacked
    opt_state = opt.init(engine.workers(params))
    cstate = consensus.init_state(dcfg.consensus, params, engine=engine)
    return TrainState(params=params, opt=opt_state, cstate=cstate, t=0,
                      round=0, engine=engine)


def _tau_of(batch):
    return next(iter(batch.values())).shape[0]


def make_round_step(loss_fn, opt: Optimizer, dcfg: DPPFConfig, *,
                    clock: Optional[RoundClock] = None,
                    base_lr: Optional[float] = None,
                    total_steps: Optional[int] = None, warmup: int = 0,
                    sam_rho: float = 0.0):
    """Build the DPPF round: tau local steps + consensus.

    The batch is a dict of tensors with leading dims ``(tau_r, M, ...)``,
    ``tau_r`` this round's length. Returns ``round_step(state, batch) ->
    (state, metrics)``; the state's flat view and optimizer state are
    updated in place."""
    if clock is None:
        if base_lr is None or total_steps is None:
            raise ValueError("make_round_step needs a RoundClock (clock=...) "
                             "or the legacy base_lr/total_steps pair")
        clock = RoundClock.from_config(dcfg, base_lr=base_lr,
                                       total_steps=total_steps, warmup=warmup)
    if dcfg.overlap != "none":
        raise _not_ported(f"overlap={dcfg.overlap!r}")
    spec = get_method(dcfg.consensus)
    lpf = spec.push_source == "filtered_grad"

    def round_step(state: TrainState, batch):
        engine = state.engine
        if engine is None:
            raise _not_ported("the tree-engine round")
        flat = state.params
        M = engine.layout.M
        loss = lambda row, b: loss_fn(engine.unflatten_row(row), b)
        tau = _tau_of(batch)
        losses = torch.empty((tau, M), dtype=torch.float32,
                             device=flat.device)
        gns = torch.empty_like(losses)
        p0 = engine.workers(flat).clone() if lpf else None
        for s in range(tau):
            lr = clock.lr_at(state.t + s)
            for m in range(M):
                row = flat[m]
                b = {k: v[s, m] for k, v in batch.items()}
                if sam_rho > 0:
                    (loss_v, _), g = sam_gradient(loss, row, b, sam_rho)
                else:
                    (loss_v, _), g = value_and_grad(loss, row, b)
                losses[s, m] = loss_v
                gns[s, m] = torch.linalg.vector_norm(g)
                opt.step(row, g, worker_state(state.opt, m), lr)
                del g

        round_idx = state.round
        lam_t = clock.lam_at(round_idx)
        ps = clock.pull_scale_at(round_idx)
        push_vec, cstate = None, state.cstate
        if lpf:
            # EMA-filtered local progress: the round's parameter delta
            push_vec = spec.filter_mu * state.cstate["g_ema"] \
                + (1.0 - spec.filter_mu) * (p0 - engine.workers(flat))
            cstate = {"g_ema": push_vec}
        with torch.no_grad():
            flat, cstate, metrics = consensus.apply_round(
                flat, dcfg, lam_t, cstate, losses=losses[-1],
                grad_norms=gns[-1], engine=engine, push_vec=push_vec,
                pull_scale=ps)
        metrics = dict(metrics)
        metrics["train_loss"] = losses.mean()
        metrics["lam_t"] = lam_t
        metrics["staleness"] = 0
        new_state = TrainState(params=flat, opt=state.opt, cstate=cstate,
                               t=state.t + tau, round=round_idx + 1,
                               engine=engine)
        return new_state, metrics

    return round_step


def stacked_params(state: TrainState):
    """The worker-stacked parameter tree."""
    if state.engine is None:
        raise _not_ported("tree-engine states")
    return state.engine.unflatten(state.params)


def average_params(state: TrainState):
    """Final returned model: the worker average (Alg. 1 last line), fp32
    leaves."""
    if state.engine is None:
        raise _not_ported("tree-engine states")
    eng = state.engine
    return eng.unflatten_row(torch.mean(eng.workers(state.params), dim=0),
                             cast=False)
