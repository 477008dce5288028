"""Training launcher: single-device DPPF rounds (or DDP) on any dense LM
config.

Counterpart of ``repro/launch/train.py`` on one device, on the flat
engine (the default here, as in the reference's launcher) and the tree
engine (``--engine tree``); ``--method ddp`` runs the per-step DDP
baseline; ``--overlap staleness1|doublebuf|staleness_k`` (with
``--overlap-chunks``, ``--staleness``, ``--elastic``,
``--elastic-catchup``) runs the overlapped rounds on the flat engine;
``--log-every-round PATH`` writes one JSON line a round. Runs on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, as the
tests do; it never falls back to the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --workers 4 --tau 4 --alpha 0.1 --lam 0.5 --steps 16 --seq 16 --batch 2

``--sharded`` (the flat worker-rows x columns mesh of all ranks) and
``--mesh W,F,M`` (hierarchical) run the sharded round
(``train.trainer.make_sharded_round_step``) with one process per rank:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --sharded --arch yi-6b --smoke --workers 4 --steps 16 --seq 16

Each rank builds the same state from ``--seed``, keeps its shard, and
draws the whole ``(tau, M, B, S)`` batch of a round from the same
generator, keeping its own worker rows, so it sees the single-device
run's data bit for bit. The transport is nccl with a card a rank, gloo
when ranks share a card (``launch/mesh.py``). Rank 0 alone prints.

Every DPPF round runs through the fault-tolerant ``train.Supervisor``, as
in the reference: with no membership and no chaos plan it is the plain
``for spec in clock.rounds`` loop, bit for bit. ``--elastic-drop W,A,B``
(a schedule) or ``--chaos PLAN.json`` (scripted kill / stall / netdrop
windows through the heartbeat table, injected OOMs, torn checkpoints)
drive the participation mask; ``--quorum`` degrades a round below it to
local steps; ``--heartbeat-timeout`` and ``--retry-budget`` set the
supervisor's policy; membership rides the elastic ``staleness_k`` carry.
``--ckpt PATH`` writes the final (serving) parameters to PATH, which
``launch.serve --ckpt`` loads, and keeps a resume point at
``<stem>.state.npz`` (one file whatever the mesh, written by rank 0),
from which a later run with the same flags resumes; a chaos run's
rotation checkpoints live in ``<stem>.sup``; on a mesh each rank reads
only its blocks of the resume point. Rank 0 alone prints the supervisor's
``supervisor events: ...`` and ``supervisor counters: ...`` lines.

``--autotune`` searches the (batch, tau, overlap_chunks) point on the
real round step before training (``train/autotune.py``): batches from
``--batch`` up to ``--max-batch``, taus ``{--tau, 2 --tau}``, at most
``--probe-budget`` probes; ``--tune-oom-above N`` makes every batch above
N fail with a scripted OOM before it touches the device. With
``--tune-plan PATH`` the plan is written there; ``--tune-plan PATH`` alone
replays a saved plan (of either package), also on a mesh. The probes run
the single-device round with the whole fleet, as the reference's do. With
``--sharded`` / ``--mesh`` rank 0 alone searches, on its own device, and
broadcasts the plan's JSON over the world; every rank then replays it on
the sharded round, prints ``autotune rank R: plan sha256 H, probes here
N`` and rank 0 alone writes ``--tune-plan``. The other ranks wait for the
plan in that broadcast, within the process group's timeout (600 s):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --workers 4 --tau 2 --steps 8 --seq 16 --batch 1 --overlap doublebuf \
      --autotune --tune-oom-above 3 --tune-plan plan.json
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint import (
    load_train_state, save_pytree, save_train_state,
)
from repro_torch.configs import ARCHS, DPPFConfig, get_arch, reduced
from repro_torch.core import methods as method_registry
from repro_torch.core.engine import tree_items
from repro_torch.data import TokenTask, make_lm_batch, make_round_batch
from repro_torch.kernels.pullpush import LAUNCHES
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    ChaosMembership, ChaosPlan, FaultInjector, RoundClock,
    RoundMetricsLogger, ScheduleMembership, Supervisor, TrainState, TunePlan,
    TuneSpace, autotune, average_params, init_train_state, inject_oom_above,
    make_ddp_step, make_lm_model_fn, make_round_probe_runner,
    make_round_step, make_sharded_round_step, shard_train_state,
    sharded_average_params,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _parser():
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="yi-6b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override d_model of the smoke config")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--lam", type=float, default=0.5)
    method_help = "; ".join(
        f"{s.name} = {s.doc}"
        for s in (method_registry.get_method(n)
                  for n in method_registry.method_names(aliases=False)))
    ap.add_argument("--method", "--consensus", dest="consensus",
                    default="simple_avg",
                    choices=method_registry.method_names(),
                    help="consensus method (registry core.methods): "
                         + method_help)
    flat_only = ", ".join(
        n for n in method_registry.method_names(aliases=False)
        if method_registry.get_method(n).requires_flat)
    ap.add_argument("--engine", default="flat", choices=["tree", "flat"],
                    help="consensus execution engine (flat = persistent "
                         "(R, n) view with the fused Gram/mixing round "
                         "update; tree = the worker-stacked tree in the "
                         "model's dtype). Registry methods marked flat-only "
                         f"({flat_only}) refuse engine=tree")
    ap.add_argument("--lam-schedule", default="increasing")
    ap.add_argument("--tau-schedule", default="fixed",
                    choices=["fixed", "qsr"])
    ap.add_argument("--qsr-beta", type=float, default=0.0)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--sam-rho", type=float, default=0.0)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8, help="per-worker batch")
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--overlap", default="none",
                    choices=["none", "staleness1", "doublebuf",
                             "staleness_k"],
                    help="staleness1 = apply the consensus of the previous "
                         "round's snapshot; doublebuf = its column "
                         "contraction in chunks before the local steps, "
                         "coefficients + one mixing pass at the boundary; "
                         "staleness_k = a k-deep snapshot ring (--staleness)"
                         " (flat engine only)")
    ap.add_argument("--overlap-chunks", type=int, default=4,
                    help="doublebuf/staleness_k: column chunks of the "
                         "snapshot's contraction")
    ap.add_argument("--staleness", type=int, default=1,
                    help="staleness_k: ring depth k; rounds 0..k-1 are "
                         "exact-consensus fill")
    ap.add_argument("--elastic", action="store_true",
                    help="staleness_k: bounded-async elastic rounds (a row "
                         "may sit out up to k rounds, then rejoins with a "
                         "catch-up pull)")
    ap.add_argument("--elastic-catchup", type=float, default=0.5,
                    help="elastic: fraction of the gap to the active-row "
                         "mean a rejoining row closes")
    ap.add_argument("--log-every-round", default="", metavar="PATH",
                    help="write one JSON line of the round metrics "
                         "(consensus_dist/pull_force/push_force/staleness, "
                         "plus the clock position) per round to PATH (the "
                         "ddp branch logs per step)")
    ap.add_argument("--legacy-metrics", action="store_true",
                    help="also write the boolean 'stale' next to "
                         "'staleness' in --log-every-round records")
    ap.add_argument("--sharded", action="store_true",
                    help="run the round on a (worker rows x columns) mesh "
                         "of all ranks (launch.mesh.make_flat_engine_mesh; "
                         "flat engine only); start one process a rank with "
                         "torchrun")
    ap.add_argument("--mesh", default="", metavar="W,F,M",
                    help="workers,fsdp,model: the round on a hierarchical "
                         "mesh of W*F*M ranks (launch.mesh.make_hier_"
                         "engine_mesh; flat engine only): worker rows over "
                         "the first axis, flat-view columns over fsdp x "
                         "model")
    ap.add_argument("--elastic-drop", default="", metavar="W,A,B",
                    help="elastic demo: worker row W sits out rounds "
                         "[A, B) (train.set_participation; the bounded-"
                         "staleness clamp still forces a rejoin after k "
                         "missed rounds), through the supervisor as the "
                         "ScheduleMembership provider")
    ap.add_argument("--chaos", default="", metavar="PLAN.json",
                    help="run under the fault-tolerant supervisor with a "
                         "replayable ChaosPlan (train.chaos): kill / stall "
                         "/ netdrop windows drive the heartbeat membership "
                         "table, oom events raise RESOURCE_EXHAUSTED at the "
                         "trainer boundary (the batch shrinks and the round "
                         "replays from the last good checkpoint), "
                         "corrupt_ckpt events tear a written checkpoint "
                         "(the restore ladder falls back to the previous "
                         "copy). The same plan replays to the same "
                         "recovery-event sequence")
    ap.add_argument("--quorum", type=int, default=0,
                    help="minimum active worker rows for a consensus round; "
                         "below it the round degrades to local-only steps "
                         "(consensus skipped bit-exactly, logged, backed "
                         "off). 0 = disabled; needs a membership source "
                         "(--chaos or --elastic-drop)")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.9,
                    help="seconds of heartbeat silence before a membership "
                         "poll counts a missed deadline (the chaos clock is "
                         "virtual: one round = 1 s); must be > 0")
    ap.add_argument("--retry-budget", type=int, default=3,
                    help="supervisor: max consecutive failed rounds "
                         "(restore + replay each) before the failure "
                         "propagates")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint path: the final (serving) params are "
                         "written here; DPPF runs also keep a resume point "
                         "at <ckpt>.state.npz and resume from it when it "
                         "exists")
    ap.add_argument("--autotune", action="store_true",
                    help="probe-search the operating point before training "
                         "(train.autotune): power-of-two batch probes with "
                         "OOM backoff and binary refinement, then a joint "
                         "(tau, overlap_chunks) sweep at the frontier batch, "
                         "scored by measured round time reconciled against "
                         "the roofline overlap model; training then runs at "
                         "the chosen point (--batch / --max-batch bound the "
                         "ladder, --tau seeds the tau ladder {tau, 2*tau})")
    ap.add_argument("--tune-plan", default="", metavar="PATH",
                    help="with --autotune: write the searched TunePlan JSON "
                         "to PATH; without: load a TunePlan from PATH and "
                         "train at its chosen point (batch, tau, "
                         "overlap_chunks)")
    ap.add_argument("--probe-budget", type=int, default=16,
                    help="autotune: most probes (distinct candidates "
                         "measured or OOMed); when spent, the best point so "
                         "far wins")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="autotune: batch-ladder ceiling (0 = 8x --batch)")
    ap.add_argument("--tune-oom-above", type=int, default=0,
                    help="autotune fault injection: probes with batch > "
                         "this raise a scripted RESOURCE_EXHAUSTED before "
                         "touching the device (0 = off)")
    return ap


def _can_start():
    """Whether this process can join a process group: one exists, or the
    environment names this rank, the world and the rendezvous, as
    torchrun's does."""
    import torch.distributed as dist
    return dist.is_initialized() or all(
        k in os.environ
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def _resume(state_file, state, clock, mesh=None, plan=None):
    """The run's state from its resume point, in place. The saved round
    index belongs to the plan that wrote the checkpoint; if this run's plan
    differs (changed --steps / --lr / tau schedule), the position is
    re-derived from the step counter — a silent mismatch would replay or
    skip data."""
    state = load_train_state(state_file, state, clock=clock, in_place=True,
                             mesh=mesh, plan=plan)
    t_res, rnd = int(state.t), int(state.round)
    if rnd >= clock.total_rounds or clock.rounds[rnd].start != t_res:
        rnd = clock.round_of_step(t_res)   # raises if t > steps
        if rnd < clock.total_rounds and clock.rounds[rnd].start != t_res:
            raise ValueError(
                f"checkpoint step {t_res} is mid-round in this run's plan "
                f"(round {rnd} starts at {clock.rounds[rnd].start}) — "
                "resume with the original --steps/--lr/--tau-schedule/"
                "--qsr-beta")
        state = dataclasses.replace(state, round=rnd)
    return state


def _run_dir(mesh):
    """A directory for this run's rotation checkpoints, made by rank 0 and
    named to every rank."""
    path = tempfile.mkdtemp(prefix="dppf-sup-") \
        if mesh is None or mesh.rank == 0 else ""
    if mesh is not None and torch.distributed.get_world_size() > 1:
        box = [path]
        torch.distributed.broadcast_object_list(box, src=0)
        path = box[0]
    return path


def main(argv=None, *, device="cuda"):
    ap = _parser()
    args = ap.parse_args(argv)
    mspec = method_registry.get_method(args.consensus)
    if (args.sharded or args.mesh) and (args.engine != "flat"
                                        or not mspec.communicates):
        ap.error("--sharded/--mesh require --engine flat and a "
                 "communicating consensus method (the sharded round runs "
                 "on the flat engine's (R, n) view)")
    if args.sharded and args.mesh:
        ap.error("--sharded and --mesh are mutually exclusive (--mesh IS "
                 "a sharded run on an explicit workers,fsdp,model shape)")
    if (args.autotune or args.tune_plan) and (
            args.tau_schedule == "qsr" or args.qsr_beta > 0):
        ap.error("--autotune/--tune-plan pin a fixed tau at the measured "
                 "comm/compute crossover; --tau-schedule qsr would "
                 "re-adapt it — drop --qsr-beta when tuning")
    if args.autotune and not mspec.communicates:
        ap.error("--autotune searches the communication round's operating "
                 "point and needs a communicating consensus method")
    mesh_shape = ()
    if args.mesh:
        try:
            mesh_shape = tuple(int(x) for x in args.mesh.split(","))
            if len(mesh_shape) != 3:
                raise ValueError
        except ValueError:
            ap.error("--mesh expects three comma-separated ints: "
                     "workers,fsdp,model (e.g. --mesh 2,2,2)")
    sharded = args.sharded or bool(mesh_shape)
    # supervisor / membership flag validation — all before any model work
    drop_spec = ()
    if args.elastic_drop:
        try:
            drop_spec = tuple(int(x) for x in args.elastic_drop.split(","))
            if len(drop_spec) != 3 or not 0 <= drop_spec[0] < args.workers:
                raise ValueError
        except ValueError:
            ap.error("--elastic-drop expects W,A,B with worker row "
                     "0 <= W < --workers (e.g. --elastic-drop 2,3,5)")
        if not 0 <= drop_spec[1] < drop_spec[2]:
            ap.error(f"--elastic-drop window [{drop_spec[1]}, "
                     f"{drop_spec[2]}) is empty or negative — need "
                     "0 <= A < B (e.g. --elastic-drop 2,3,5)")
    if args.chaos and drop_spec:
        ap.error("--chaos and --elastic-drop are mutually exclusive (the "
                 "plan's kill/stall/netdrop events already script the "
                 "membership windows)")
    if args.heartbeat_timeout <= 0:
        ap.error("--heartbeat-timeout must be > 0 seconds")
    if args.retry_budget < 0:
        ap.error("--retry-budget must be >= 0")
    if not 0 <= args.quorum <= args.workers:
        ap.error(f"--quorum {args.quorum} must be in [0, --workers] "
                 f"({args.workers})")
    chaos_plan = None
    if args.chaos:
        try:
            chaos_plan = ChaosPlan.load(args.chaos)
        except ValueError as e:
            ap.error(f"--chaos {args.chaos}: {e}")
    if args.quorum and chaos_plan is None and not drop_spec:
        ap.error("--quorum needs a membership source: a --chaos plan or "
                 "an --elastic-drop window")
    needs_membership = bool(drop_spec) or args.quorum > 0 or (
        chaos_plan is not None and bool(chaos_plan.membership_events()))
    if needs_membership and args.overlap != "staleness_k":
        ap.error("membership-driven rounds (--elastic-drop / --quorum / "
                 "a --chaos plan with kill|stall|netdrop events) ride the "
                 "elastic staleness_k carry — add --overlap staleness_k "
                 "(with --staleness K)")
    if needs_membership and not mspec.communicates:
        ap.error("membership/quorum supervision needs a communicating "
                 "consensus method (a local-only method never syncs, so "
                 "there is nothing to degrade or rejoin)")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "launcher on the CPU")
    mesh = plan = None
    started = False
    if sharded:
        import torch.distributed as dist

        from repro_torch.launch import mesh as mesh_mod
        if not _can_start():
            ap.error("--sharded/--mesh: no process group to join"
                     + (" (--autotune probes the single-device round on "
                        "rank 0 and broadcasts its plan to every rank)"
                        if args.autotune else "") + ": "
                     + mesh_mod.HOW_TO_START)
        started = not dist.is_initialized()
        device = mesh_mod.start(device)
        if mesh_shape:
            mesh, plan = mesh_mod.make_hier_engine_mesh(*mesh_shape,
                                                        device=device)
        else:
            mesh, plan = mesh_mod.make_flat_engine_mesh(args.workers,
                                                        device=device)
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)

    cfg = get_arch(args.arch)
    if args.smoke:
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        head_dim=max(args.d_model // 4, 32),
                        d_ff=2 * args.d_model if cfg.d_ff else 0)
        if args.layers:
            over["n_layers"] = args.layers
        cfg = reduced(cfg, **over)
    model = build_model(cfg)
    n_params = sum(leaf.numel()
                   for _, leaf in tree_items(model.init(None, "meta")))
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M workers={args.workers} "
        f"tau={args.tau} alpha={args.alpha} lam={args.lam} device={device}")

    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=args.seq)
    dcfg = DPPFConfig(alpha=args.alpha, lam=args.lam, tau=args.tau,
                      consensus=args.consensus, engine=args.engine,
                      overlap=args.overlap,
                      overlap_chunks=args.overlap_chunks,
                      staleness=args.staleness,
                      elastic=args.elastic or needs_membership,
                      elastic_catchup=args.elastic_catchup,
                      lam_schedule=args.lam_schedule,
                      tau_schedule=args.tau_schedule, qsr_beta=args.qsr_beta)
    opt = make_optimizer(args.optimizer, momentum=0.9, weight_decay=1e-3)

    # --autotune: search the (batch, tau, overlap_chunks) point on the real
    # round step before committing to it; --tune-plan alone replays a plan
    batch_size, tune_plan = args.batch, None
    if args.autotune:
        space = TuneSpace(min_batch=args.batch,
                          max_batch=args.max_batch or args.batch * 8,
                          taus=(args.tau, args.tau * 2), chunks=(1, 2, 4),
                          probe_budget=args.probe_budget,
                          overlap=args.overlap, staleness=args.staleness)
        probes_here = 0
        if rank0:
            runner = make_round_probe_runner(
                model.init, model.loss, opt, dcfg, args.workers,
                lambda cand: make_round_batch(task, args.seed, args.workers,
                                              cand.tau, 0, cand.batch, cfg,
                                              device=device),
                base_lr=args.lr, total_steps=args.steps, seed=args.seed,
                device=device)
            if args.tune_oom_above:
                runner = inject_oom_above(runner, args.tune_oom_above)

            def counted(cand):
                nonlocal probes_here
                probes_here += 1
                return runner(cand)
            model_fn = make_lm_model_fn(n_params=n_params, seq=args.seq,
                                        workers=args.workers,
                                        overlap=args.overlap,
                                        staleness=args.staleness)
            tune_plan = autotune(counted, model_fn, space)
        if mesh is not None:
            # rank 0's plan, as its JSON, on every rank
            box = [tune_plan.dumps() if rank0 else None]
            if mesh.size > 1:
                torch.distributed.broadcast_object_list(box, src=0)
            tune_plan = TunePlan.from_dict(json.loads(box[0]))
            print(f"autotune rank {mesh.rank}: plan sha256 "
                  f"{hashlib.sha256(box[0].encode()).hexdigest()}, probes "
                  f"here {probes_here}", flush=True)
        ch = tune_plan.chosen
        say(f"autotune: chose batch={ch.batch} tau={ch.tau} "
            f"chunks={ch.overlap_chunks} after {tune_plan.probes_used} "
            f"probes (OOM batches: {list(tune_plan.failures) or 'none'}, "
            f"model scale {tune_plan.residual_scale:.3f})")
        if args.tune_plan:
            if rank0:
                tune_plan.save(args.tune_plan)
            say(f"tune plan -> {args.tune_plan}")
    elif args.tune_plan:
        tune_plan = TunePlan.load(args.tune_plan)
        ch = tune_plan.chosen
        say(f"tune plan <- {args.tune_plan}: batch={ch.batch} "
            f"tau={ch.tau} chunks={ch.overlap_chunks}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    # the RoundClock owns the step / round accounting; a tune plan pins its
    # tau and the config's overlap chunks and batch
    if tune_plan is not None:
        clock = RoundClock.from_tune_plan(tune_plan, base_lr=args.lr,
                                          total_steps=args.steps,
                                          warmup=args.warmup, dcfg=dcfg)
        dcfg = dcfg.apply_tune_plan(tune_plan)
        batch_size = tune_plan.chosen.batch
    else:
        clock = RoundClock.from_config(dcfg, base_lr=args.lr,
                                       total_steps=args.steps,
                                       warmup=args.warmup)
    logger = RoundMetricsLogger(args.log_every_round,
                                legacy=args.legacy_metrics) \
        if args.log_every_round and rank0 else None

    t0 = time.time()
    launches0 = dict(LAUNCHES)
    if not mspec.communicates:
        p0 = model.init(gen, device)
        state = TrainState(params=p0, opt=opt.init(p0), cstate={})
        step = make_ddp_step(model.loss, opt, clock=clock,
                             sam_rho=args.sam_rho)
        for s in range(args.steps):
            bs = [make_lm_batch(task, args.seed, m, s, batch_size, cfg,
                                device=device) for m in range(args.workers)]
            batch = {k: torch.stack([b[k] for b in bs]) for k in bs[0]}
            state, m = step(state, batch)
            if logger is not None:   # ddp: per step on the tau=1 clock
                logger(s, m)
            if s % (args.log_every * args.tau) == 0:
                print(f"step {s:5d} loss {float(m['train_loss']):.4f}")
        final = state.params
    else:
        state = init_train_state(model.init, opt, dcfg, args.workers, gen,
                                 device=device)
        # the resume point lives next to the final-params checkpoint
        # (which keeps its serving format at args.ckpt, see launch/serve.py)
        state_file = stem = ""
        if args.ckpt:
            stem = args.ckpt[:-4] if args.ckpt.endswith(".npz") else args.ckpt
            state_file = stem + ".state.npz"
        own = slice(None)
        if mesh is not None:
            from repro_torch.launch.mesh import transport
            say(f"sharded round on mesh {mesh.shape} "
                f"(transport {transport(device)['backend']})")
            state = shard_train_state(state, mesh, plan, dcfg=dcfg)
            step = make_sharded_round_step(model.loss, opt, dcfg, mesh=mesh,
                                           plan=plan, clock=clock,
                                           sam_rho=args.sam_rho)
            m_loc = args.workers // mesh.axis_size(plan.worker_axes)
            first = mesh.lin_index(plan.worker_axes) * m_loc
            own = slice(first, first + m_loc)
        else:
            step = make_round_step(model.loss, opt, dcfg, clock=clock,
                                   sam_rho=args.sam_rho)
        if state_file and os.path.exists(state_file):
            # a resume point written under any mesh (or none): each rank
            # reads its own blocks into its shard
            state = _resume(state_file, state, clock, mesh, plan)
            say(f"resumed from {state_file} at step {state.t} "
                f"(round {state.round})")
        # the fault-tolerant supervisor owns the round iteration
        # (train/supervisor.py); with no membership and no chaos it is the
        # plain `for spec in clock.rounds` loop
        membership = injector = None
        if chaos_plan is not None:
            injector = FaultInjector(chaos_plan)
            if needs_membership:
                membership = ChaosMembership(chaos_plan, args.workers,
                                             timeout=args.heartbeat_timeout)
        elif drop_spec:
            membership = ScheduleMembership(args.workers, [drop_spec])
        sup_dir, scratch = "", False
        if chaos_plan is not None:
            # recovery checkpoints (the sup_last / sup_prev rotation pair)
            # live next to the resume point when --ckpt names one, else in
            # a directory for this run only, the same on every rank
            sup_dir = stem + ".sup" if stem else _run_dir(mesh)
            scratch = not stem

        def on_round(spec, m):
            if spec.index % args.log_every == 0:
                say(f"round {spec.index:4d} "
                    f"(step {spec.start + spec.tau:5d} tau {spec.tau:3d}) "
                    f"loss {float(m['train_loss']):.4f} "
                    f"consensus_dist {float(m['consensus_dist']):.3f} "
                    f"lam_t {float(m['lam_t']):.3f}")

        def batch_fn(spec, bs):
            # every rank draws the whole round batch and keeps its rows
            batch = make_round_batch(task, args.seed, args.workers,
                                     spec.tau, spec.start, bs, cfg,
                                     device="cpu")
            return {k: v[:, own].to(device) for k, v in batch.items()}

        sup = Supervisor(clock, workers=args.workers, membership=membership,
                         quorum=args.quorum, retry_budget=args.retry_budget,
                         chaos=injector, ckpt_dir=sup_dir,
                         tune_plan=tune_plan, batch_size=batch_size,
                         logger=logger,
                         on_round=on_round, mesh=mesh,
                         plan=plan, seed=args.seed)
        try:
            state = sup.run(state, step, batch_fn, start_round=state.round)
        finally:
            if scratch and rank0:
                shutil.rmtree(sup_dir, ignore_errors=True)
        if sup.events:
            sm = sup.summary()
            say("supervisor events: " + " ".join(sm["event_seq"]))
            say("supervisor counters: " + " ".join(
                f"{k}={v}" for k, v in sm["counters"].items())
                + f" final_batch={sm['final_batch']}")
        say(f"comm rounds {clock.total_rounds} "
            f"(fixed tau={args.tau} would take {clock.fixed_rounds}; "
            f"all-reduces saved {clock.fixed_rounds - clock.total_rounds})"
            " kernel launches " + " ".join(
                f"{k}={v - launches0[k]}" for k, v in LAUNCHES.items()
                if v > launches0[k]))
        if state_file:
            save_train_state(state_file, state, mesh=mesh, plan=plan)
            say(f"train-state resume point -> {state_file}")
        final = average_params(state) if mesh is None \
            else sharded_average_params(state, mesh, plan)

    # held-out eval
    eval_batch = make_lm_batch(task, args.seed + 999, 0, 10 ** 6,
                               batch_size * args.workers, cfg, device=device)
    with torch.no_grad():
        loss, _ = model.loss(final, eval_batch)
    if logger is not None:
        logger.close()
        say(f"round metrics -> {args.log_every_round}")
    say(f"eval loss {float(loss):.4f}  wall {time.time() - t0:.1f}s")
    if args.ckpt:
        if rank0:
            save_pytree(args.ckpt, final, extra={"steps": args.steps})
        say(f"checkpoint -> {args.ckpt}")
        if mesh is not None:
            torch.distributed.barrier()
    if started:
        import torch.distributed as dist
        dist.destroy_process_group()
    return float(loss)


if __name__ == "__main__":
    main()
