"""DPPF trainer: one communication ROUND is tau purely-local optimizer steps
per worker followed by the consensus pull-push update; the DDP baseline is
a separate per-step function that averages the workers' gradients.

Counterpart of ``repro/train/trainer.py`` on one device, on both engines:

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

``DPPFConfig.overlap`` runs the reference's stale-consensus recursion on
the flat engine (DESIGN.md §Overlap):

* ``staleness1``: the consensus of the PREVIOUS round's snapshot, its
  delta applied to this round's post-step view q; round 0 is a bubble
  (local steps only).
* ``doublebuf``: the snapshot's column contraction (``engine.stage_comm``
  over ``overlap_chunks`` column chunks, read in place) runs before the
  local steps, leaving the coefficients and one mixing pass at the round
  boundary; round 0 is an exact consensus of the fresh view.
* ``staleness_k``: a k-deep snapshot ring, oldest -> newest; round r
  applies the consensus of the round-(r-k) snapshot, rounds 0..k-1 are
  exact-consensus fill. ``DPPFConfig.elastic`` adds bounded-async
  membership (``set_participation``).

The carry is built for one card, not transcribed: each snapshot is an
(R, n) buffer and nothing else of that size is allocated. The boundary
writes the new rows over the consumed snapshot's storage (the stale
epilogue ``q + (C(s) - s)`` as one ``stale_mix`` pass in place over s, a
fill round's consensus of q into it), and the buffers swap: the new
params take s's storage, the fresh q becomes the newest snapshot. The ring
is a list of views rotated by reference (the reference concatenates k
views a round). A dropped elastic row runs its local steps as the
reference's scan does (their losses and gradient norms feed the snapshot
and the metrics), and is then restored from a copy of its parameter and
optimizer-state rows kept in page-locked host memory (allocated once,
reused every round): no device memory, four row copies over PCIe a
frozen row a round.

The sharded round is not ported yet.
"""
from __future__ import annotations

import dataclasses
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
    snap: Any = None     # overlap carry (flat engine only). staleness1/
                         # doublebuf: {"x": (R, n) snapshot, "losses":
                         # (M,), "gns": (M,)}; staleness_k: a k-deep ring
                         # oldest -> newest, {"x": [k views (R, n)],
                         # "losses": (k, M), "gns": (k, M)} plus, when
                         # elastic, {"act": (k, M) participation at
                         # snapshot time, "active": (M,) requested
                         # membership, "missed": (M,) int32 consecutive
                         # misses, "sync": () quorum gate}
    round: int = 0       # round counter — the clock position
    engine: Any = None   # ConsensusEngine, or None on the tree engine


def _chunk_bounds(n: int, k: int):
    """Split ``range(n)`` into ``k`` contiguous near-equal pieces (host
    ints; first pieces absorb the remainder) — the overlap modes' snapshot
    column chunks."""
    base, rem = divmod(n, k)
    bounds, a = [], 0
    for i in range(k):
        b = a + base + (1 if i < rem else 0)
        bounds.append((a, b))
        a = b
    return bounds


def _init_snap(dcfg, params, M):
    """The overlap carry: the init fleet in every snapshot slot."""
    dev = params.device
    if dcfg.overlap == "staleness_k":
        k = dcfg.staleness
        snap = {"x": [params.clone() for _ in range(k)],
                "losses": torch.zeros((k, M), dtype=torch.float32,
                                      device=dev),
                "gns": torch.ones((k, M), dtype=torch.float32, device=dev)}
        if dcfg.elastic:
            snap.update(
                act=torch.ones((k, M), dtype=torch.float32, device=dev),
                active=torch.ones((M,), dtype=torch.float32, device=dev),
                missed=torch.zeros((M,), dtype=torch.int32, device=dev),
                sync=torch.ones((), dtype=torch.float32, device=dev))
        return snap
    return {"x": params.clone(),
            "losses": torch.zeros((M,), dtype=torch.float32, device=dev),
            "gns": torch.ones((M,), dtype=torch.float32, device=dev)}


def init_train_state(loss_params_init, opt: Optimizer, dcfg: DPPFConfig,
                     n_workers: int, gen, *, device, same_init=True,
                     engine=None):
    """Stack per-worker params from ``loss_params_init(gen, device)``. The
    paper initializes all workers from the same random model (Alg. 1);
    ``same_init=False`` draws one model per worker from ``gen``.

    With ``dcfg.engine == "flat"`` (or an explicit ``engine``) the stacked
    tree is flattened once into the engine's persistent (R, n) view; on the
    tree engine it is materialised in the model's dtype."""
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
    snap = None
    if engine is None:
        if dcfg.overlap != "none":
            raise ValueError(
                f"overlap={dcfg.overlap!r} requires engine='flat' (the "
                "stale snapshot is an extra (R, n) flat buffer)")
        params = tree_from_items([(path, leaf.contiguous())
                                  for path, leaf in tree_items(stacked)])
        opt_state = opt.init(params, workers=n_workers)
        cstate = consensus.init_state(dcfg.consensus, params)
    else:
        params = engine.flatten(stacked)          # the ONE flatten per run
        opt_state = opt.init(engine.workers(params), workers=n_workers)
        cstate = consensus.init_state(dcfg.consensus, params, engine=engine)
        if dcfg.overlap != "none":
            snap = _init_snap(dcfg, params, n_workers)
    del stacked
    return TrainState(params=params, opt=opt_state, cstate=cstate, t=0,
                      snap=snap, round=0, engine=engine)


def set_participation(state: TrainState, active, *,
                      sync=None) -> TrainState:
    """Host-side elastic-membership hook: set which worker rows take part
    in the NEXT rounds (1 = active, 0 = dropped). A dropped row freezes
    (its local steps revert, its pull/push coefficients zero, and its row
    leaves the consensus target weights) until it is re-activated here —
    or until it has missed ``dcfg.staleness`` consecutive rounds, when the
    bounded-staleness rule forces it back in. Requires an elastic
    staleness_k state. ``sync`` sets the quorum gate: 0.0 makes the next
    rounds local-only (the consensus application is skipped bit-exactly,
    the ring still advances), 1.0 restores them, ``None`` keeps it."""
    if state.snap is None or "active" not in state.snap:
        raise ValueError(
            "set_participation requires an elastic staleness_k TrainState "
            "(DPPFConfig.overlap='staleness_k', elastic=True)")
    dev = state.snap["active"].device
    act = consensus.as_participation_mask(
        active, state.snap["active"].shape[0], device=dev)
    new_snap = dict(state.snap, active=act)
    if sync is not None:
        new_snap["sync"] = torch.as_tensor(
            sync, dtype=torch.float32, device=dev).reshape(())
    return dataclasses.replace(state, snap=new_snap)


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
    mode = dcfg.overlap
    spec = get_method(dcfg.consensus)
    lpf = spec.push_source == "filtered_grad"
    host = {}       # frozen rows' copies in host memory, reused

    def keep(key, t):
        buf = host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = host[key] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=t.is_cuda)
        return buf.copy_(t)

    def round_step(state: TrainState, batch):
        engine = state.engine
        params = state.params
        if mode != "none" and engine is None:
            raise ValueError(f"overlap={mode!r} requires the flat engine")
        if engine is None:
            M = tree_items(params)[0][1].shape[0]
            loss, worker = loss_fn, (lambda m: tree_at(params, m))
        else:
            M = engine.layout.M
            loss = lambda row, b: loss_fn(engine.unflatten_row(row), b)
            worker = lambda m: params[m]
        round_idx = state.round
        lam_t = clock.lam_at(round_idx)
        ps = clock.pull_scale_at(round_idx)
        snap = state.snap
        k = dcfg.staleness if mode == "staleness_k" else 1
        # the rounds that apply a stale delta (the rest are fill/bubble)
        stale = state.t > 0 if mode in ("staleness1", "doublebuf") \
            else round_idx >= k
        eff, frozen = None, ()
        if dcfg.elastic:
            # bounded staleness: a row that already missed k rounds is
            # forced back in this round
            eff = torch.where(snap["missed"] >= k,
                              torch.ones_like(snap["active"]),
                              snap["active"])
            frozen = [m for m, e in enumerate(eff.tolist()) if e == 0]
        gram = None
        if mode in ("doublebuf", "staleness_k") and stale:
            with torch.no_grad():
                gram = _chunk_gram(engine, dcfg, lam_t, ps, snap)

        dev = leaves(params)[0].device
        tau = _tau_of(batch)
        losses = torch.empty((tau, M), dtype=torch.float32, device=dev)
        gns = torch.empty_like(losses)
        p0 = engine.workers(params).clone() if lpf else None
        # a frozen elastic row steps as the reference's scan does, then
        # reverts: its rows are kept in host memory meanwhile
        kept = {m: [keep((i, j), t) for j, t in enumerate(
                    [params[m]] + leaves(worker_state(state.opt, m)))]
                for i, m in enumerate(frozen)}
        for s in range(tau):
            lr = clock.lr_at(state.t + s)
            for m in range(M):
                p_m = worker(m)
                b = {k_: v[s, m] for k_, v in batch.items()}
                if sam_rho > 0:
                    (loss_v, _), g = sam_gradient(loss, p_m, b, sam_rho)
                else:
                    (loss_v, _), g = value_and_grad(loss, p_m, b)
                losses[s, m] = loss_v
                gns[s, m] = grad_norm(g)
                opt.step(p_m, g, worker_state(state.opt, m), lr)
                del g
        for m, rows in kept.items():
            for dst, src in zip([params[m]]
                                + leaves(worker_state(state.opt, m)), rows):
                dst.copy_(src)
        del kept

        push_vec, cstate = None, state.cstate
        if lpf:
            # EMA-filtered local progress: the round's parameter delta
            # (zero for a frozen row, whose steps reverted)
            push_vec = spec.filter_mu * state.cstate["g_ema"] \
                + (1.0 - spec.filter_mu) * (p0 - engine.workers(params))
            cstate = {"g_ema": push_vec}
        with torch.no_grad():
            if mode == "none":
                params, cstate, metrics = consensus.apply_round(
                    params, dcfg, lam_t, cstate, losses=losses[-1],
                    grad_norms=gns[-1], engine=engine, push_vec=push_vec,
                    pull_scale=ps)
                new_snap, depth = snap, 0
            elif mode == "staleness1":
                params, new_snap, metrics = _staleness1(
                    engine, dcfg, lam_t, cstate, params, snap, losses, gns,
                    push_vec, ps, stale)
                depth = int(stale)
            else:
                params, new_snap, metrics = _ring_round(
                    engine, dcfg, lam_t, cstate, params, snap, losses, gns,
                    push_vec, ps, stale, gram, eff)
                depth = k if stale else 0
        metrics = dict(metrics)
        metrics["train_loss"] = losses.mean()
        metrics["lam_t"] = lam_t
        metrics["staleness"] = depth
        new_state = TrainState(params=params, opt=state.opt, cstate=cstate,
                               t=state.t + tau, snap=new_snap,
                               round=round_idx + 1, engine=engine)
        return new_state, metrics

    return round_step


def _oldest(snap, key):
    """The oldest snapshot's entry: slot 0 of a staleness_k ring, the one
    snapshot of staleness1 / doublebuf."""
    return snap[key][0] if isinstance(snap["x"], list) else snap[key]


def _chunk_gram(engine, dcfg, lam_t, ps, snap):
    """The oldest snapshot's stage-1 column contraction, summed over
    ``overlap_chunks`` column chunks read in place. It depends on nothing
    the round computes, so it runs before the local steps (on a mesh its
    gather and psum would overlap them)."""
    stages, _ = consensus.lower_stages(
        engine, dcfg, lam_t, losses=_oldest(snap, "losses"),
        grad_norms=_oldest(snap, "gns"),
        mask=_oldest(snap, "act") if "act" in snap else None, pull_scale=ps)
    T1 = stages[0][1]
    s, n = _oldest(snap, "x"), engine.layout.n
    gram = None
    for a, b in _chunk_bounds(n, max(1, min(dcfg.overlap_chunks, n))):
        part = engine.stage_comm(s[:, a:b], T1)
        gram = part if gram is None else gram + part
    return gram


def _staleness1(engine, dcfg, lam_t, cstate, q, snap, losses, gns, push_vec,
                ps, live):
    """The consensus of the previous round's snapshot s, its delta applied
    to the fresh view q (over s's storage); round 0 keeps q (the
    reference's bubble ``q + 0 (C(s) - s)``) and s takes a copy of it."""
    s = snap["x"]
    new, _, metrics = consensus.apply_round(
        s, dcfg, lam_t, cstate, losses=snap["losses"],
        grad_norms=snap["gns"], engine=engine, push_vec=push_vec,
        pull_scale=ps, base=q)
    if live:
        params, x = new, q
    else:
        params, x = q, s.copy_(q)
    return params, {"x": x, "losses": losses[-1], "gns": gns[-1]}, metrics


def _ring_round(engine, dcfg, lam_t, cstate, q, snap, losses, gns, push_vec,
                ps, stale, gram, eff):
    """doublebuf (a ring of one) and staleness_k: a stale round applies the
    oldest snapshot's consensus delta to q, written over that snapshot's
    storage; a fill round writes the exact consensus of q there. Then the
    elastic gates, and the ring advances with q as its newest slot."""
    ring = isinstance(snap["x"], list)
    s_old = _oldest(snap, "x")
    if stale:
        new, _, metrics = consensus.apply_round(
            s_old, dcfg, lam_t, cstate, losses=_oldest(snap, "losses"),
            grad_norms=_oldest(snap, "gns"), engine=engine, first_gram=gram,
            mask=_oldest(snap, "act") if eff is not None else None,
            push_vec=push_vec, pull_scale=ps, base=q)
    else:
        new, _, metrics = consensus.apply_round(
            q, dcfg, lam_t, cstate, losses=losses[-1], grad_norms=gns[-1],
            engine=engine, mask=eff, push_vec=push_vec, pull_scale=ps,
            out=s_old)
    if eff is not None:
        _elastic_gates(engine, dcfg, new, q, eff, snap)
    if not ring:
        return new, {"x": q, "losses": losses[-1], "gns": gns[-1]}, metrics
    new_snap = {
        "x": snap["x"][1:] + [q],
        "losses": torch.cat([snap["losses"][1:], losses[-1][None]]),
        "gns": torch.cat([snap["gns"][1:], gns[-1][None]])}
    if eff is not None:
        missed = snap["missed"]
        new_snap.update(
            act=torch.cat([snap["act"][1:], eff[None]]),
            active=snap["active"],
            missed=torch.where(eff > 0, torch.zeros_like(missed),
                               missed + 1),
            sync=snap["sync"])
    return new, new_snap, metrics


_CATCHUP_CHUNK = 1 << 24


def _elastic_gates(engine, dcfg, new, q, eff, snap):
    """The elastic round's gates, in place on ``new``: a row inactive NOW
    keeps its frozen q (reception gate); a row rejoining after >= 1 missed
    rounds pulls ``elastic_catchup`` of the way toward the active-row mean
    (in column chunks, touching only those rows); ``sync == 0`` leaves
    every row at q."""
    M = engine.layout.M
    effs = eff.tolist()
    for m in range(M):
        if effs[m] == 0:
            new[m].copy_(q[m])
    rejoin = [m for m in range(M)
              if effs[m] > 0 and int(snap["missed"][m]) > 0]
    if rejoin:
        w = eff[:, None]
        denom = torch.clamp(torch.sum(eff), min=1.0)
        for a in range(0, engine.layout.n, _CATCHUP_CHUNK):
            cols = new[:M, a:a + _CATCHUP_CHUNK]
            mean = torch.sum(w * cols, dim=0) / denom
            for m in rejoin:
                cols[m] += (mean - cols[m]) * dcfg.elastic_catchup
    if float(snap["sync"]) == 0:
        new.copy_(q)


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
