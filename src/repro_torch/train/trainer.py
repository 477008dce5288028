"""DPPF trainer: one communication ROUND is tau purely-local optimizer steps
per worker followed by the consensus pull-push update; the DDP baseline is
a separate per-step function that averages the workers' gradients.

Counterpart of ``repro/train/trainer.py`` with ``overlap="none"``, on both
engines:

* flat (``DPPFConfig.engine == "flat"``): the worker parameters live in
  the ConsensusEngine's persistent ``(R, n)`` fp32 view for the whole run:
  ``init_train_state`` builds it once, each local step differentiates
  through ``torch.split`` views of one worker row
  (``engine.unflatten_row``, cast to the model's dtype), and the optimizer
  updates that row and its momentum in place — the port's counterpart of
  ``jax.jit(round_step, donate_argnums=0)``. The consensus stage then runs
  on the same view (in place on the kernel path).
* tree (the reference's default): the parameters are a worker-stacked
  tree in the model's dtype (bf16 at full size, with fp32 optimizer
  state: every step and every consensus update rounds to bf16, as in the
  reference). Each local step differentiates with respect to the views
  ``leaf[m]`` of one worker and steps them in place; the consensus is
  ``consensus.apply_round(engine=None)``, whose distances and updates run
  through the ``sq_dist`` / ``apply_update`` kernels, and returns a new
  tree.

Local steps loop over workers, so one worker's gradient is alive at a
time; this loop is the counterpart of the reference's ``jax.vmap`` over
workers (``_scan_local_steps``), and the loop over steps that of its
``lax.scan``. Batched over workers, the gradients of all M would be alive
at once (19.5 GB more for yi-6b at 4 layers).

The sharded round, the overlap modes and ``set_participation`` (which
needs the elastic overlap carry) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import DPPFConfig
from repro_torch.core import consensus
from repro_torch.core.engine import (
    ConsensusEngine, tree_at, tree_from_items, tree_items,
)
from repro_torch.core.methods import get_method
from repro_torch.core.pullpush import tree_mean0
from repro_torch.optim import Optimizer, sam_gradient, value_and_grad
from repro_torch.optim.optimizers import (
    grad_norm, leaves, tree_like, worker_state,
)
from repro_torch.train.clock import RoundClock


@dataclass
class TrainState:
    params: Any          # the engine's (R, n) flat view; a worker-stacked
                         # tree on the tree engine; one replica's tree
                         # for DDP
    opt: Any             # optimizer state over the workers (one replica
                         # for DDP)
    cstate: Any          # consensus state (LPF-SGD's g_ema, the tree
                         # engine's easgd/parle center)
    t: int = 0           # local-step counter
    snap: Any = None     # overlap carry (not ported: always None)
    round: int = 0       # round counter — the clock position
    engine: Any = None   # ConsensusEngine, or None on the tree engine


def _not_ported(what):
    return NotImplementedError(f"not yet ported: {what}")


def init_train_state(loss_params_init, opt: Optimizer, dcfg: DPPFConfig,
                     n_workers: int, gen, *, device, same_init=True,
                     engine=None):
    """Stack per-worker params from ``loss_params_init(gen, device)``. The
    paper initializes all workers from the same random model (Alg. 1);
    ``same_init=False`` draws one model per worker from ``gen``.

    With ``dcfg.engine == "flat"`` (or an explicit ``engine``) the stacked
    tree is flattened once into the engine's persistent (R, n) view; on the
    tree engine it is materialised in the model's dtype."""
    if dcfg.overlap != "none":
        raise _not_ported(f"overlap={dcfg.overlap!r}")
    if same_init:
        # broadcast views: the flat engine copies each leaf straight into
        # its view, the tree engine materialises them below
        stacked = tree_from_items([
            (path, leaf.unsqueeze(0).expand((n_workers,) + leaf.shape))
            for path, leaf in tree_items(loss_params_init(gen, device))])
    else:
        models = [tree_items(loss_params_init(gen, device))
                  for _ in range(n_workers)]
        stacked = tree_from_items([
            (path, torch.stack([m[i][1] for m in models]))
            for i, (path, _) in enumerate(models[0])])
    if engine is None and dcfg.engine == "flat" \
            and get_method(dcfg.consensus).communicates:
        engine = ConsensusEngine.from_stacked(
            stacked, method=dcfg.consensus, eps=dcfg.eps)
    if engine is None:
        params = tree_from_items([(path, leaf.contiguous())
                                  for path, leaf in tree_items(stacked)])
        opt_state = opt.init(params, workers=n_workers)
        cstate = consensus.init_state(dcfg.consensus, params)
    else:
        params = engine.flatten(stacked)          # the ONE flatten per run
        opt_state = opt.init(engine.workers(params), workers=n_workers)
        cstate = consensus.init_state(dcfg.consensus, params, engine=engine)
    del stacked
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
        params = state.params
        if engine is None:
            M = tree_items(params)[0][1].shape[0]
            loss, worker = loss_fn, (lambda m: tree_at(params, m))
        else:
            M = engine.layout.M
            loss = lambda row, b: loss_fn(engine.unflatten_row(row), b)
            worker = lambda m: params[m]
        dev = leaves(params)[0].device
        tau = _tau_of(batch)
        losses = torch.empty((tau, M), dtype=torch.float32, device=dev)
        gns = torch.empty_like(losses)
        p0 = engine.workers(params).clone() if lpf else None
        for s in range(tau):
            lr = clock.lr_at(state.t + s)
            for m in range(M):
                p_m = worker(m)
                b = {k: v[s, m] for k, v in batch.items()}
                if sam_rho > 0:
                    (loss_v, _), g = sam_gradient(loss, p_m, b, sam_rho)
                else:
                    (loss_v, _), g = value_and_grad(loss, p_m, b)
                losses[s, m] = loss_v
                gns[s, m] = grad_norm(g)
                opt.step(p_m, g, worker_state(state.opt, m), lr)
                del g

        round_idx = state.round
        lam_t = clock.lam_at(round_idx)
        ps = clock.pull_scale_at(round_idx)
        push_vec, cstate = None, state.cstate
        if lpf:
            # EMA-filtered local progress: the round's parameter delta
            push_vec = spec.filter_mu * state.cstate["g_ema"] \
                + (1.0 - spec.filter_mu) * (p0 - engine.workers(params))
            cstate = {"g_ema": push_vec}
        with torch.no_grad():
            params, cstate, metrics = consensus.apply_round(
                params, dcfg, lam_t, cstate, losses=losses[-1],
                grad_norms=gns[-1], engine=engine, push_vec=push_vec,
                pull_scale=ps)
        metrics = dict(metrics)
        metrics["train_loss"] = losses.mean()
        metrics["lam_t"] = lam_t
        metrics["staleness"] = 0
        new_state = TrainState(params=params, opt=state.opt, cstate=cstate,
                               t=state.t + tau, round=round_idx + 1,
                               engine=engine)
        return new_state, metrics

    return round_step


def make_ddp_step(loss_fn, opt: Optimizer, *,
                  clock: Optional[RoundClock] = None,
                  base_lr: Optional[float] = None,
                  total_steps: Optional[int] = None, warmup: int = 0,
                  sam_rho: float = 0.0):
    """DDP baseline: one replica; the per-worker gradients are averaged
    (fp32) every step. The batch's leading dim is M (the worker/data
    axis). The LR comes from a ``RoundClock`` (tau = 1: DDP is the
    per-step clock). Returns ``step(state, batch) -> (state, metrics)``;
    the state's params and optimizer state are updated in place."""
    if clock is None:
        if base_lr is None or total_steps is None:
            raise ValueError("make_ddp_step needs a RoundClock (clock=...) "
                             "or the legacy base_lr/total_steps pair")
        clock = RoundClock(total_steps=total_steps, tau=1, base_lr=base_lr,
                           warmup=warmup)

    def step(state: TrainState, batch):
        M = _tau_of(batch)
        dev = leaves(state.params)[0].device
        losses = torch.empty((M,), dtype=torch.float32, device=dev)
        acc = None
        for m in range(M):
            b = {k: v[m] for k, v in batch.items()}
            if sam_rho > 0:
                (loss_v, _), g = sam_gradient(loss_fn, state.params, b,
                                              sam_rho)
            else:
                (loss_v, _), g = value_and_grad(loss_fn, state.params, b)
            losses[m] = loss_v
            gl = [x.to(torch.float32) for x in leaves(g)]
            acc = gl if acc is None else [a.add_(x) for a, x in zip(acc, gl)]
            del g, gl
        mean = [a.div_(M) for a in acc]
        opt.step(state.params, tree_like(state.params, mean), state.opt,
                 clock.lr_at(state.t))
        new_state = TrainState(params=state.params, opt=state.opt,
                               cstate=state.cstate, t=state.t + 1)
        # the unified round-metrics schema: DDP's single replica has no
        # worker spread and no stale consensus, so the consensus fields
        # are zeros
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return new_state, {"train_loss": losses.mean(),
                           "consensus_dist": zero, "pre_dist": zero,
                           "pull_force": zero, "push_force": zero,
                           "lam_t": zero, "staleness": 0}

    return step


def stacked_params(state: TrainState):
    """The worker-stacked parameter tree, whichever engine holds it."""
    if state.engine is not None:
        return state.engine.unflatten(state.params)
    return state.params


def average_params(state: TrainState):
    """Final returned model: the worker average (Alg. 1 last line), fp32
    leaves on either engine."""
    if state.engine is not None:
        eng = state.engine
        return eng.unflatten_row(torch.mean(eng.workers(state.params),
                                            dim=0), cast=False)
    return tree_mean0(state.params)
