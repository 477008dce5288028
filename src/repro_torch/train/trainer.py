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

``make_sharded_round_step`` runs the same round on a mesh of
``torch.distributed`` ranks (``launch/mesh.py``), with the reference's
collective placement: each rank holds its worker rows' column shard of the
view (``shard_train_state``), the tau local steps run on its own rows'
column-gathered parameters with no worker-axis collective, and at the
boundary the rows are gathered per column shard into the full (R, n_local)
view, whose column contractions the engine completes over the column
group. ``staleness1`` reads the row-replicated snapshot; ``doublebuf``
keeps only its own rows valid (in their place of an (R, n_local) buffer,
whose other rows each chunk's row gather fills) and issues each chunk's
gather and partial-Gram all-reduce before a segment of the local steps,
waiting at the boundary. ``staleness_k`` keeps a ring of such buffers
and gathers its oldest slot's rows over ``launch.mesh.ring_gather``
(R - 1 neighbour hops, the all-gather's order); the elastic gates run on
this rank's rows, the catch-up mean over the rows gathered column chunk
by column chunk, as the single-device round forms it.

``whole_leaves`` and ``state_template`` give the checkpoint module the
whole state of a shard (gathered leaf by leaf), where the shard's blocks
lie in it, and the shapes a restore allocates.
"""
from __future__ import annotations

import dataclasses
import traceback
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import DPPFConfig
from repro_torch.core import consensus
from repro_torch.core.engine import (
    ConsensusEngine, ShardedLayout, tree_at, tree_from_items, tree_items,
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
        if "sync" not in state.snap:
            raise ValueError(
                "sync gating requires a state whose elastic carry has the "
                "sync gate (DPPFConfig.elastic; checkpoints from before the "
                "gate are backfilled by checkpoint.load_train_state)")
        new_snap["sync"] = torch.as_tensor(
            sync, dtype=torch.float32, device=dev).reshape(())
    return dataclasses.replace(state, snap=new_snap)


def _tau_of(batch):
    return next(iter(batch.values())).shape[0]


def _round_index(state, dcfg):
    """The index of the round about to run: the state's clock position,
    or, for a state restored from a checkpoint that carried only its step
    counter, the pre-scan ``t // tau`` (right for the fixed-tau runs that
    wrote such checkpoints)."""
    return state.round if state.round is not None \
        else state.t // dcfg.tau


def _host_keeper():
    """``keep(key, t)``: a copy of ``t`` in a host buffer kept under
    ``key`` and reused (page-locked for a card tensor)."""
    host = {}

    def keep(key, t):
        buf = host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = host[key] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=t.is_cuda)
        return buf.copy_(t)
    return keep


def _freeze(keep, worker, opt_state, rows):
    """Keep worker rows ``rows`` (their parameters and optimizer state)
    in host memory; the returned function puts them back (an elastic row
    that sits out steps as the reference's scan does, then reverts)."""
    def tensors(m):
        return [worker(m)] + leaves(worker_state(opt_state, m))
    kept = {m: [keep((i, j), t) for j, t in enumerate(tensors(m))]
            for i, m in enumerate(rows)}

    def restore():
        for m, saved in kept.items():
            for dst, src in zip(tensors(m), saved):
                dst.copy_(src)
        kept.clear()
    return restore


def _round_clock(clock, dcfg, base_lr, total_steps, warmup, who):
    if clock is not None:
        return clock
    if base_lr is None or total_steps is None:
        raise ValueError(f"{who} needs a RoundClock (clock=...) or the "
                         "legacy base_lr/total_steps pair")
    return RoundClock.from_config(dcfg, base_lr=base_lr,
                                  total_steps=total_steps, warmup=warmup)


def _local_steps(loss, opt, worker, opt_state, batch, t0, steps, clock,
                 sam_rho, losses, gns):
    """The round's local steps ``steps`` (indices into the batch's leading
    dim) for every worker row ``worker(m)``, m < ``losses.shape[1]``: each
    row and its optimizer state step in place; losses and gradient norms
    land in ``losses[s, m]`` / ``gns[s, m]``."""
    for s in steps:
        lr = clock.lr_at(t0 + s)
        for m in range(losses.shape[1]):
            p_m = worker(m)
            b = {k: v[s, m] for k, v in batch.items()}
            if sam_rho > 0:
                (loss_v, _), g = sam_gradient(loss, p_m, b, sam_rho)
            else:
                (loss_v, _), g = value_and_grad(loss, p_m, b)
            losses[s, m] = loss_v
            gns[s, m] = grad_norm(g)
            opt.step(p_m, g, worker_state(opt_state, m), lr)
            del g


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
    clock = _round_clock(clock, dcfg, base_lr, total_steps, warmup,
                         "make_round_step")
    mode = dcfg.overlap
    spec = get_method(dcfg.consensus)
    lpf = spec.push_source == "filtered_grad"
    keep = _host_keeper()       # frozen rows' copies in host memory

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
        round_idx = _round_index(state, dcfg)
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
        restore = _freeze(keep, worker, state.opt, frozen)
        _local_steps(loss, opt, worker, state.opt, batch, state.t,
                     range(tau), clock, sam_rho, losses, gns)
        restore()

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


# ---------------------------------------------------------------------------
# the sharded round (torch.distributed)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Shard:
    """This rank's block of the flat view on a mesh: rows
    ``[r_off, r_off + m_loc)`` of the M worker rows (plus all aux rows),
    columns ``[c_off, c_off + n_loc)``."""
    layout: ShardedLayout
    m_loc: int
    n_loc: int
    r_off: int
    c_off: int
    row_group: Any


def _shard_of(engine, mesh, plan) -> _Shard:
    from repro_torch.launch.mesh import flat_col_axes
    L = engine.layout
    row_axes = tuple(plan.worker_axes)
    rows = mesh.axis_size(row_axes)
    if L.M % rows:
        raise ValueError(f"workers ({L.M}) not divisible over worker axes "
                         f"{row_axes} (size {rows})")
    col_axes = flat_col_axes(mesh, L.n, plan)
    cols = mesh.axis_size(col_axes)
    m_loc, n_loc = L.M // rows, L.n // cols
    return _Shard(ShardedLayout(row_axes=row_axes, col_axes=col_axes,
                                rows=rows, cols=cols,
                                col_group=mesh.group(col_axes)),
                  m_loc, n_loc, mesh.lin_index(row_axes) * m_loc,
                  mesh.lin_index(col_axes) * n_loc, mesh.group(row_axes))


def make_sharded_round_step(loss_fn, opt: Optimizer, dcfg: DPPFConfig, *,
                            mesh, plan, clock: Optional[RoundClock] = None,
                            base_lr: Optional[float] = None,
                            total_steps: Optional[int] = None,
                            warmup: int = 0, sam_rho: float = 0.0):
    """Build the DPPF round on a mesh of ranks (flat engine only): worker
    rows of the (R, n) view over ``plan.worker_axes``, columns over
    ``plan.fsdp_axes + plan.model_axes`` (``launch.mesh.flat_col_axes``).

    The state is this rank's shard (``shard_train_state``); the batch
    holds this rank's worker rows, ``(tau_r, M / rows, ...)``. Collective
    placement, as in the reference: the local steps run on this rank's
    rows gathered over the column group (no worker-axis collective); the
    boundary gathers the rows per column shard (the paper's one consensus
    all-reduce), and the engine completes its Gram over the column group;
    the (R, R) coefficient math and the mix stay shard-local, and this
    rank's rows are copied back out. ``staleness1`` mixes the
    row-replicated snapshot. ``doublebuf`` carries the snapshot
    row-sharded — this rank's rows and the aux rows are valid, in their
    place of an (R, n_local) buffer — and before each of its segments of
    the local steps it issues one column chunk's row gather into that
    buffer, and once that has landed the chunk's partial-Gram all-reduce,
    both asynchronous; the boundary waits for them and runs only the
    coefficients and the mix; round 0 is an exact consensus of the fresh
    view. The snapshot is gathered in place, not beside a row-sharded
    copy: two ranks on one card hold one (R, n_local) buffer each, not
    two. ``staleness_k`` carries a ring of k such buffers, oldest ->
    newest: a stale round (r >= k) gathers the oldest slot chunk by chunk
    as doublebuf does, its row gathers over ``launch.mesh.ring_gather``;
    a fill round (r < k) runs the exact consensus of the fresh rows; the
    consumed slot's buffer takes this round's rows as the newest. With
    ``dcfg.elastic`` this rank's dropped rows sit out (their steps
    revert), the reception gate, the catch-up toward the active-row mean
    (over the rows gathered in column chunks: the single-device round's
    sum) and the ``sync`` gate run on its rows. Returns
    ``round_step(state, batch) -> (state, metrics)``; the shard and
    optimizer state are updated in place."""
    from repro_torch.launch.mesh import all_gather, all_reduce
    clock = _round_clock(clock, dcfg, base_lr, total_steps, warmup,
                         "make_sharded_round_step")
    mode = dcfg.overlap
    sk = mode == "staleness_k"
    k = dcfg.staleness if sk else 1
    spec = get_method(dcfg.consensus)
    lpf = spec.push_source == "filtered_grad"
    keep = _host_keeper()       # frozen rows' copies in host memory

    def round_step(state: TrainState, batch):
        engine = state.engine
        if engine is None:
            raise ValueError("make_sharded_round_step requires the flat "
                             "engine (DPPFConfig.engine='flat')")
        L = engine.layout
        M, aux = L.M, L.aux
        sh = _shard_of(engine, mesh, plan)
        m_loc, n_loc = sh.m_loc, sh.n_loc
        s_engine = dataclasses.replace(engine, shard=sh.layout)
        blk, snap = state.params, state.snap
        if tuple(blk.shape) != (m_loc + aux, n_loc):
            raise ValueError(f"state.params {tuple(blk.shape)} is not this "
                             f"rank's ({m_loc + aux}, {n_loc}) shard: "
                             "place the state with shard_train_state")
        slots = snap["x"] if sk else [snap["x"]] if snap else []
        if mode != "none" and (sk != isinstance(snap["x"], list) or any(
                tuple(x.shape) != (L.R, n_loc) for x in slots)):
            raise ValueError(f"{mode}'s snapshot is (a ring of) (R, "
                             "n_local) buffers: place it with "
                             "shard_train_state")
        tau = _tau_of(batch)
        if next(iter(batch.values())).shape[1] != m_loc:
            raise ValueError(f"the batch holds {m_loc} worker rows a rank "
                             "(this rank's rows of the (tau, M, ...) batch)")
        round_idx = _round_index(state, dcfg)
        lam_t = clock.lam_at(round_idx)
        ps = clock.pull_scale_at(round_idx)
        stale = round_idx >= k if sk else state.t > 0
        eff, frozen = None, []
        if dcfg.elastic:
            # bounded staleness: a row that already missed k rounds is
            # forced back in; this rank's dropped rows sit out
            eff = torch.where(snap["missed"] >= k,
                              torch.ones_like(snap["active"]),
                              snap["active"])
            effs = eff.tolist()
            frozen = [i for i in range(m_loc) if effs[sh.r_off + i] == 0]
        losses = torch.empty((tau, m_loc), dtype=torch.float32,
                             device=blk.device)
        gns = torch.empty_like(losses)
        p0 = blk[:m_loc].clone() if lpf else None
        # this rank's rows at full width: a view of blk with one column
        # shard, else a gathered buffer whose own columns are the block's
        # rows; the block's storage is then released for the local steps
        # (the round consumes its state, as the reference's donated
        # buffers) and refilled after them
        w_full = all_gather(blk[:m_loc], sh.layout.col_group, dim=1)
        released = None
        if sh.layout.cols > 1:
            released = (blk[m_loc:].clone(), blk.untyped_storage().nbytes())
            blk.untyped_storage().resize_(0)
        loss = lambda row, b: loss_fn(engine.unflatten_row(row), b)
        worker = lambda m: w_full[m]
        fault = []

        def step(r):
            # a fault in this rank's local steps is held, its remaining
            # steps skipped, and the round's collectives issued as on
            # every rank until the ranks agree on it below
            if fault:
                return
            try:
                _local_steps(loss, opt, worker, state.opt, batch, state.t,
                             r, clock, sam_rho, losses, gns)
            except Exception as e:  # noqa: BLE001 — agreed, then re-raised
                e.add_note("".join(traceback.format_exception(e)))
                fault.append(e.with_traceback(None))  # frees its frames

        restore = _freeze(keep, worker, state.opt, frozen)
        gram = None
        if mode in ("doublebuf", "staleness_k") and stale:
            s_full, gram = _doublebuf_steps(s_engine, sh, dcfg, lam_t, ps,
                                            snap, tau, step)
        else:
            step(range(tau))
        restore()
        _agree_local_steps(mesh, fault, blk.device)

        with torch.no_grad():
            if released is not None:
                aux_rows, nbytes = released
                blk.untyped_storage().resize_(nbytes)
                blk[:m_loc].copy_(w_full[:, sh.c_off:sh.c_off + n_loc])
                blk[m_loc:].copy_(aux_rows)
                del aux_rows, released
            del w_full
            l_last = all_gather(losses[-1], sh.row_group)
            g_last = all_gather(gns[-1], sh.row_group)
            push_vec, cstate = None, state.cstate
            if lpf:
                delta = all_gather(p0.sub_(blk[:m_loc]), sh.row_group)
                push_vec = spec.filter_mu * state.cstate["g_ema"] \
                    + (1.0 - spec.filter_mu) * delta
                cstate = {"g_ema": push_vec}
            run = dict(dcfg=dcfg, lam_t=lam_t, state=cstate,
                       engine=s_engine, push_vec=push_vec, pull_scale=ps)
            if sk:
                params, new_snap, metrics = _sharded_ring_round(
                    sh, s_engine, dcfg, run, blk, snap, stale, gram, eff,
                    l_last, g_last)
            elif mode == "doublebuf" and stale and sh.layout.rows == 1:
                # one row shard: the shard is the whole (R, n_local) view,
                # so the stale epilogue runs over the snapshot as on one
                # card and the buffers swap
                params, _, metrics = consensus.apply_round(
                    s_full, losses=snap["losses"], grad_norms=snap["gns"],
                    first_gram=gram, base=blk, **run)
                new_snap = {"x": blk, "losses": l_last, "gns": g_last}
            elif mode == "doublebuf" and stale:
                # C(s) beside s; this rank's rows of the delta C(s) - s go
                # onto q, and q becomes the snapshot's valid rows
                out = torch.empty_like(s_full) if engine.use_kernel \
                    else None
                c_out, _, metrics = consensus.apply_round(
                    s_full, losses=snap["losses"], grad_norms=snap["gns"],
                    first_gram=gram, out=out, **run)
                own = slice(sh.r_off, sh.r_off + m_loc)
                d_own = c_out[own].sub_(s_full[own])
                d_aux = c_out[M:].sub_(s_full[M:])
                _put_q(sh, s_full, blk, M)
                blk[:m_loc].add_(d_own)
                blk[m_loc:].add_(d_aux)
                del c_out, d_own, d_aux, out
                params = blk
                new_snap = {"x": s_full, "losses": l_last, "gns": g_last}
            elif mode == "doublebuf":
                # round 0: the snapshot takes q, then the exact consensus
                _put_q(sh, snap["x"], blk, M)
                X, metrics = _exact_round(sh, blk, M, aux, l_last, g_last,
                                          run)
                params = _own_rows(sh, blk, X, M, aux)
                new_snap = {"x": snap["x"], "losses": l_last,
                            "gns": g_last}
            elif mode == "staleness1":
                X = _gather_rows(sh, blk, aux)
                full, new_snap, metrics = _staleness1(
                    s_engine, dcfg, lam_t, cstate, X, snap, l_last[None],
                    g_last[None], push_vec, ps, stale)
                params = _own_rows(sh, blk, full, M, aux)
            else:
                X, metrics = _exact_round(sh, blk, M, aux, l_last, g_last,
                                          run)
                params = _own_rows(sh, blk, X, M, aux)
                new_snap = snap
            metrics = dict(metrics)
            train_loss = all_reduce(losses.mean().reshape(1),
                                    sh.row_group)[0] / sh.layout.rows
        metrics["train_loss"] = train_loss
        metrics["lam_t"] = lam_t
        metrics["staleness"] = (k if stale else 0) if mode != "none" \
            else 0
        new_state = TrainState(params=params, opt=state.opt, cstate=cstate,
                               t=state.t + tau, snap=new_snap,
                               round=round_idx + 1, engine=engine)
        return new_state, metrics

    return round_step


def _agree_local_steps(mesh, fault, device):
    """Every rank learns whether any rank's local steps failed, through an
    all-reduce of ``[failed, oom]`` over the whole mesh (before the
    boundary's collectives, in which the others would wait for it): the
    failed rank raises its own exception, the others a RuntimeError, and
    a ``train.Supervisor`` around the step agrees on the OOM flag again.
    A fault inside a collective is not caught here: the process group's
    timeout (``launch.mesh.start``) ends such a wait in an error."""
    from repro_torch.launch.mesh import all_reduce
    from repro_torch.train.autotune import is_oom
    if mesh.size == 1:
        if fault:
            raise fault[0]
        return
    flag = torch.tensor([float(bool(fault)),
                         float(bool(fault) and is_oom(fault[0]))],
                        device=device)
    all_reduce(flag, mesh.group(mesh.axis_names))
    if fault:
        raise fault[0]
    if flag.device.type == "meta":    # a traced round: no values to agree on
        return
    if float(flag[0]) > 0:
        raise RuntimeError("the round's local steps failed on another rank"
                           + (" (out of memory)" if float(flag[1]) > 0
                              else ""))


def _sharded_ring_round(sh, s_engine, dcfg, run, blk, snap, stale, gram,
                        eff, l_last, g_last):
    """staleness_k's boundary on a shard. Stale: the oldest slot S, now
    gathered, takes the consensus delta onto this rank's rows (with one
    row shard, the stale epilogue over S as on one card). Fill: the exact
    consensus of the fresh rows. The consumed slot's buffer (or, with one
    row shard, ``blk`` itself) holds this round's rows q and becomes the
    newest slot; then the elastic gates."""
    M, m_loc = s_engine.layout.M, sh.m_loc
    aux = s_engine.layout.aux
    S = snap["x"][0]
    act0 = snap["act"][0] if eff is not None else None
    one = sh.layout.rows == 1
    if stale and one:
        params, _, metrics = consensus.apply_round(
            S, losses=snap["losses"][0], grad_norms=snap["gns"][0],
            first_gram=gram, mask=act0, base=blk, **run)
        newest = blk
    elif stale:
        out = torch.empty_like(S) if s_engine.use_kernel else None
        c_out, _, metrics = consensus.apply_round(
            S, losses=snap["losses"][0], grad_norms=snap["gns"][0],
            first_gram=gram, mask=act0, out=out, **run)
        own = slice(sh.r_off, sh.r_off + m_loc)
        d_own = c_out[own].sub_(S[own])
        d_aux = c_out[M:].sub_(S[M:])
        _put_q(sh, S, blk, M)
        blk[:m_loc].add_(d_own)
        blk[m_loc:].add_(d_aux)
        del c_out, d_own, d_aux, out
        params, newest = blk, S
    elif one:
        params, _, metrics = consensus.apply_round(
            blk, losses=l_last, grad_norms=g_last, mask=eff, out=S, **run)
        newest = blk
    else:
        _put_q(sh, S, blk, M)
        X = _gather_rows(sh, blk, aux, ring=True)
        X, _, metrics = consensus.apply_round(
            X, losses=l_last, grad_norms=g_last, mask=eff, **run)
        params, newest = _own_rows(sh, blk, X, M, aux), S
        del X
    new_snap = {
        "x": snap["x"][1:] + [newest],
        "losses": torch.cat([snap["losses"][1:], l_last[None]]),
        "gns": torch.cat([snap["gns"][1:], g_last[None]])}
    if eff is not None:
        if one:
            _elastic_gates(s_engine, dcfg, params, newest, eff, snap)
        else:
            _sharded_gates(sh, dcfg, params, newest, eff, snap, M)
        missed = snap["missed"]
        new_snap.update(
            act=torch.cat([snap["act"][1:], eff[None]]),
            active=snap["active"],
            missed=torch.where(eff > 0, torch.zeros_like(missed),
                               missed + 1))
        if "sync" in snap:
            new_snap["sync"] = snap["sync"]
    return params, new_snap, metrics


def _sharded_gates(sh, dcfg, blk, Q, eff, snap, M):
    """``_elastic_gates`` on this rank's rows ``blk`` (its worker rows,
    then the aux rows), ``Q`` an (R, n_local) buffer whose rows of this
    rank and aux rows hold q. The catch-up mean is formed over the worker
    rows gathered over the row group, a column chunk at a time, by the
    single-device round's sum."""
    from repro_torch.launch.mesh import all_gather
    m_loc, r_off = sh.m_loc, sh.r_off
    effs = eff.tolist()
    for i in range(m_loc):
        if effs[r_off + i] == 0:
            blk[i].copy_(Q[r_off + i])
    rejoin = [m for m in range(M)
              if effs[m] > 0 and int(snap["missed"][m]) > 0]
    if rejoin:
        w = eff[:, None]
        denom = torch.clamp(torch.sum(eff), min=1.0)
        for a in range(0, sh.n_loc, _CATCHUP_CHUNK):
            cols = all_gather(blk[:m_loc, a:a + _CATCHUP_CHUNK],
                              sh.row_group)
            mean = torch.sum(w * cols, dim=0) / denom
            for m in rejoin:
                if r_off <= m < r_off + m_loc:
                    row = blk[m - r_off, a:a + _CATCHUP_CHUNK]
                    row += (mean - row) * dcfg.elastic_catchup
            del cols, mean
    if "sync" in snap and float(snap["sync"]) == 0:
        blk[:m_loc].copy_(Q[r_off:r_off + m_loc])
        blk[m_loc:].copy_(Q[M:])


def _put_q(sh, S, blk, M):
    """This rank's block (its worker rows and the aux rows) into their
    place of the (R, n_local) snapshot ``S``."""
    S[sh.r_off:sh.r_off + sh.m_loc].copy_(blk[:sh.m_loc])
    S[M:].copy_(blk[sh.m_loc:])


def _gather_rows(sh, blk, aux, *, ring=False):
    """This rank's worker rows gathered over the row group, with the aux
    rows: the full (R, n_local) view of its column shard (``ring``: over
    ``ring_gather``, the same bits). With one row shard that is ``blk``
    itself."""
    from repro_torch.launch.mesh import all_gather, ring_gather
    if sh.layout.rows == 1:
        return blk
    rows = ring_gather(blk[:sh.m_loc], sh.row_group,
                       axes=sh.layout.row_axes) if ring \
        else all_gather(blk[:sh.m_loc], sh.row_group)
    return torch.cat([rows, blk[sh.m_loc:]]) if aux else rows


def _own_rows(sh, blk, full, M, aux):
    """The shard's rows of a full (R, n_local) view, copied into ``blk``
    (or ``full`` itself when it is the shard)."""
    if sh.layout.rows == 1:
        return full
    blk[:sh.m_loc].copy_(full[sh.r_off:sh.r_off + sh.m_loc])
    if aux:
        blk[sh.m_loc:].copy_(full[M:])
    return blk


def _exact_round(sh, blk, M, aux, l_last, g_last, run):
    """The consensus of the fresh rows: gather, the engine's stages on the
    (R, n_local) view (in place on the kernel route)."""
    X = _gather_rows(sh, blk, aux)
    X, _, metrics = consensus.apply_round(X, losses=l_last,
                                          grad_norms=g_last, **run)
    return X, metrics


def _doublebuf_steps(s_engine, sh, dcfg, lam_t, ps, snap, tau, step):
    """doublebuf's (and staleness_k's) local steps in ``n_eff`` segments.
    Before segment j the row gather of the oldest snapshot's column chunk
    j is issued (``ring_gather`` for a staleness_k ring); once it has
    landed in its place (before segment j + 1, or at the boundary for the
    last), the chunk's stage-1 partial Gram is formed in place and its
    all-reduce issued. Returns the gathered (R, n_local) snapshot and the
    summed Gram."""
    from repro_torch.launch.mesh import all_gather, ring_gather
    ring = isinstance(snap["x"], list)
    stages, _ = consensus.lower_stages(
        s_engine, dcfg, lam_t, losses=_oldest(snap, "losses"),
        grad_norms=_oldest(snap, "gns"),
        mask=_oldest(snap, "act") if "act" in snap else None, pull_scale=ps)
    T1 = stages[0][1]
    S, m_loc, rows = _oldest(snap, "x"), sh.m_loc, sh.layout.rows
    gather = (lambda x: ring_gather(x, sh.row_group,
                                    axes=sh.layout.row_axes, async_op=True)) \
        if ring else (lambda x: all_gather(x, sh.row_group, async_op=True))
    M = m_loc * rows
    own = slice(sh.r_off, sh.r_off + m_loc)
    n_eff = max(1, min(dcfg.overlap_chunks, tau, sh.n_loc))
    parts = []

    def land(pending, a, b):
        if pending is not None:
            S[:M, a:b].copy_(pending.wait())
        with torch.no_grad():
            parts.append(s_engine.stage_comm(S[:, a:b], T1, async_op=True))

    prev = None
    for (a, b), (sa, sz) in zip(_chunk_bounds(sh.n_loc, n_eff),
                                _chunk_bounds(tau, n_eff)):
        nxt = (gather(S[own, a:b]) if rows > 1 else None, a, b)
        if prev is not None:
            land(*prev)
        prev = nxt
        step(range(sa, sz))
    land(*prev)
    gram = None
    for p in parts:
        g = p.wait()
        gram = g if gram is None else gram + g
    return S, gram


def shard_train_state(state: TrainState, mesh, plan, *, dcfg=None):
    """This rank's shard of a whole flat-engine ``TrainState`` for
    ``make_sharded_round_step``, on ``mesh.device``. Every rank builds
    the same whole state (the same seed) and keeps its block: the (R, n)
    view's worker rows of this rank plus the aux rows, at its columns; the
    optimizer state of its worker rows at full width (the local steps run
    there); LPF-SGD's filtered field at its columns; the overlap
    snapshot's (R, n_local) columns (``staleness1`` mixes them whole,
    ``doublebuf`` keeps this rank's rows and gathers the rest), each slot
    of a ``staleness_k`` ring alike; the elastic carry whole. A block
    that is all of a tensor on its device is that tensor (the whole state
    is meant to be dropped), any other block a copy."""
    if state.engine is None:
        raise ValueError("shard_train_state requires a flat-engine "
                         "TrainState (DPPFConfig.engine='flat')")
    snap = state.snap
    L = state.engine.layout
    sh = _shard_of(state.engine, mesh, plan)
    dev = mesh.device
    cols = slice(sh.c_off, sh.c_off + sh.n_loc)

    def take(v, part):
        """``part`` of v on ``dev``: v itself when that is all of it, else
        a copy (a view would keep the whole storage alive)."""
        if tuple(part.shape) == tuple(v.shape):
            return v.to(dev).contiguous()
        return part.to(dev, copy=True).contiguous()

    def block(x):
        own = x[sh.r_off:sh.r_off + sh.m_loc, cols]
        if L.aux:
            own = torch.cat([own, x[L.M:, cols]])
        return take(x, own)

    def rows(v):
        if v.dim() and v.shape[0] == L.M:
            return take(v, v[sh.r_off:sh.r_off + sh.m_loc])
        return v.to(dev, copy=True)

    new_snap = None
    if snap is not None:
        new_snap = {k: v.to(dev, copy=True) for k, v in snap.items()
                    if k != "x"}
        x = snap["x"]
        new_snap["x"] = [take(s, s[:, cols]) for s in x] \
            if isinstance(x, list) else take(x, x[:, cols])
    cstate = {k: take(v, v[:, cols]) if v.dim() == 2
              else v.to(dev, copy=True) for k, v in state.cstate.items()}
    return TrainState(params=block(state.params),
                      opt={k: tree_like(v, [rows(leaf) for leaf in leaves(v)])
                           for k, v in state.opt.items()},
                      cstate=cstate, t=state.t, snap=new_snap,
                      round=state.round, engine=state.engine)


def unshard_params(state: TrainState, mesh, plan):
    """The whole (R, n) view of a sharded state, on every rank (for checks
    at small sizes: it gathers the view)."""
    from repro_torch.launch.mesh import all_gather
    L = state.engine.layout
    sh = _shard_of(state.engine, mesh, plan)
    blk = state.params
    X = _gather_rows(sh, blk, L.aux)
    return all_gather(X, sh.layout.col_group, dim=1)


def sharded_average_params(state: TrainState, mesh, plan):
    """Alg. 1's returned model on a mesh: the worker mean (fp32 leaves),
    summed over the row group, gathered over the column group."""
    from repro_torch.launch.mesh import all_gather, all_reduce
    L = state.engine.layout
    sh = _shard_of(state.engine, mesh, plan)
    part = torch.sum(state.params[:sh.m_loc], dim=0)
    mean = all_reduce(part, sh.row_group) / L.M
    return state.engine.unflatten_row(
        all_gather(mean, sh.layout.col_group, dim=0), cast=False)


def whole_leaves(state: TrainState, mesh, plan):
    """The whole state of a shard, for the checkpoint module:
    ``[(key, shape, dtype, parts, local, rows, cols)]``, one entry a leaf
    in checkpoint order: its whole shape, ``parts`` callables that gather
    its slices along dim 0 (one slice, or a ring's slots one by one), this
    rank's tensor of it (a ring's first slot), and where that tensor lies
    in the whole (in each slot of a ring): ``rows`` the indices along dim
    0 (None: all) and ``cols`` the ``(start, stop)`` of the last dim of a
    2-D leaf (None: all), as ``shard_train_state`` takes them. Every rank
    must call every part in this order: each gathers over the mesh; the
    rest needs no collective (a template of meta tensors will do)."""
    from repro_torch.launch.mesh import all_gather
    L = state.engine.layout
    sh = _shard_of(state.engine, mesh, plan)
    cg = sh.layout.col_group
    cols = (sh.c_off, sh.c_off + sh.n_loc)
    own = list(range(sh.r_off, sh.r_off + sh.m_loc))
    out = []

    def rows_of(x):
        # this rank's worker rows of an (R, n_local) buffer, with the aux
        # rows, gathered over the mesh into the whole (R, n) (a view of
        # the rows where there are no aux rows: no copy beside them)
        blk = x[sh.r_off:sh.r_off + sh.m_loc]
        if L.aux:
            blk = torch.cat([blk, x[L.M:]])
        return unshard_params(dataclasses.replace(state, params=blk), mesh,
                              plan)

    def add(key, shape, v, parts, rows=None, cols=None):
        out.append((key, tuple(shape), v.dtype, parts, v, rows, cols))

    for k in sorted(state.cstate):
        v = state.cstate[k]
        if v.dim() == 2:
            add(f"cstate::{k}", (v.shape[0], L.n), v,
                [lambda v=v: all_gather(v, cg, dim=1)], cols=cols)
        else:
            add(f"cstate::{k}", v.shape, v, [lambda v=v: v])
    for path, v in tree_items(state.opt):
        key = "::".join(("opt",) + tuple(str(p) for p in path))
        if v.dim() and v.shape[0] == sh.m_loc and sh.layout.rows > 1:
            add(key, (L.M,) + tuple(v.shape[1:]), v,
                [lambda v=v: all_gather(v, sh.row_group)], rows=own)
        else:
            add(key, v.shape, v, [lambda v=v: v])
    add("params", (L.R, L.n), state.params,
        [lambda: unshard_params(state, mesh, plan)],
        rows=own + list(range(L.M, L.R)), cols=cols)
    if state.snap is not None:
        for k in sorted(state.snap):
            v = state.snap[k]
            if k != "x":
                add(f"snap::{k}", v.shape, v, [lambda v=v: v])
            elif isinstance(v, list):
                add("snap::x", (len(v), L.R, L.n), v[0],
                    [lambda s=s: rows_of(s) for s in v], cols=cols)
            else:
                add("snap::x", (L.R, L.n), v, [lambda v=v: rows_of(v)],
                    cols=cols)
    return out


_SMALL = 1 << 20


def state_template(state: TrainState):
    """A ``TrainState`` of ``state``'s shapes and dtypes, what a restore
    needs of its template: meta tensors, but for small leaves (the
    snapshot's scalars and vectors), which are kept as CPU copies. For a
    shard it is the shard's template (``checkpoint.load_train_state``
    with ``mesh`` reads this rank's blocks into it). The engine is
    kept."""
    def whole(t):
        if t.numel() * t.element_size() <= _SMALL:
            return t.detach().to("cpu", copy=True)
        return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")

    def tree(x):
        if x is None:
            return None
        if isinstance(x, list):
            return [whole(v) for v in x]
        if isinstance(x, torch.Tensor):
            return whole(x)
        return tree_from_items([(p, whole(v)) for p, v in tree_items(x)])
    snap = None if state.snap is None else \
        {k: tree(v) for k, v in state.snap.items()}
    return dataclasses.replace(
        state, params=tree(state.params),
        opt={k: tree(v) for k, v in state.opt.items()},
        cstate={k: tree(v) for k, v in state.cstate.items()}, snap=snap)


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
