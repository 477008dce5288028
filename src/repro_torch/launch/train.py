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

The round loop is the plain ``for spec in clock.rounds`` — the reference's
supervisor with no membership and no chaos plan, bit for bit. The
supervisor (``--elastic-drop``, ``--quorum``, ``--chaos``), autotune and
checkpoints are not ported yet: their flags exit with "not yet ported".
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import ARCHS, DPPFConfig, get_arch, reduced
from repro_torch.core import methods as method_registry
from repro_torch.core.engine import tree_items
from repro_torch.data import TokenTask, make_lm_batch, make_round_batch
from repro_torch.kernels.pullpush import LAUNCHES
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    RoundClock, RoundMetricsLogger, TrainState, average_params,
    init_train_state, make_ddp_step, make_round_step,
    make_sharded_round_step, shard_train_state, sharded_average_params,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

NOT_PORTED = "not yet ported"


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
    # reference flags whose paths are not ported yet
    ap.add_argument("--autotune", action="store_true", help=NOT_PORTED)
    for flag in ("--chaos", "--tune-plan", "--ckpt", "--elastic-drop"):
        ap.add_argument(flag, default="", help=NOT_PORTED)
    ap.add_argument("--quorum", type=int, default=0, help=NOT_PORTED)
    return ap


def _can_start():
    """Whether this process can join a process group: one exists, or the
    environment names this rank, the world and the rendezvous, as
    torchrun's does."""
    import torch.distributed as dist
    return dist.is_initialized() or all(
        k in os.environ
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def main(argv=None, *, device="cuda"):
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, used in (("--chaos", args.chaos),
                       ("--elastic-drop", args.elastic_drop),
                       ("--quorum", args.quorum),
                       ("--autotune", args.autotune),
                       ("--tune-plan", args.tune_plan), ("--ckpt", args.ckpt)):
        if used:
            ap.error(f"{flag}: {NOT_PORTED}")
    mspec = method_registry.get_method(args.consensus)
    if (args.sharded or args.mesh) and (args.engine != "flat"
                                        or not mspec.communicates):
        ap.error("--sharded/--mesh require --engine flat and a "
                 "communicating consensus method (the sharded round runs "
                 "on the flat engine's (R, n) view)")
    if args.sharded and args.mesh:
        ap.error("--sharded and --mesh are mutually exclusive (--mesh IS "
                 "a sharded run on an explicit workers,fsdp,model shape)")
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
    if sharded and (args.overlap == "staleness_k" or args.elastic):
        ap.error("--sharded/--mesh with --overlap staleness_k or "
                 f"--elastic: {NOT_PORTED} (it comes with ring_gather)")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "launcher on the CPU")
    mesh = plan = None
    started = False
    if sharded:
        import torch.distributed as dist

        from repro_torch.launch import mesh as mesh_mod
        if not _can_start():
            ap.error("--sharded/--mesh: no process group to join: "
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
                      staleness=args.staleness, elastic=args.elastic,
                      elastic_catchup=args.elastic_catchup,
                      lam_schedule=args.lam_schedule,
                      tau_schedule=args.tau_schedule, qsr_beta=args.qsr_beta)
    opt = make_optimizer(args.optimizer, momentum=0.9, weight_decay=1e-3)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    clock = RoundClock.from_config(dcfg, base_lr=args.lr,
                                   total_steps=args.steps, warmup=args.warmup)
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
            bs = [make_lm_batch(task, args.seed, m, s, args.batch, cfg,
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
        for spec in clock.rounds:
            # every rank draws the whole round batch and keeps its rows
            batch = make_round_batch(task, args.seed, args.workers, spec.tau,
                                     spec.start, args.batch, cfg,
                                     device="cpu")
            batch = {k: v[:, own].to(device) for k, v in batch.items()}
            state, m = step(state, batch)
            if spec.index % args.log_every == 0:
                say(f"round {spec.index:4d} "
                      f"(step {spec.start + spec.tau:5d} tau {spec.tau:3d}) "
                      f"loss {float(m['train_loss']):.4f} "
                      f"consensus_dist {float(m['consensus_dist']):.3f} "
                      f"lam_t {float(m['lam_t']):.3f}")
            if logger is not None:
                logger(spec, m)
        say(f"comm rounds {clock.total_rounds} "
              f"(fixed tau={args.tau} would take {clock.fixed_rounds}; "
              f"all-reduces saved {clock.fixed_rounds - clock.total_rounds})"
              " kernel launches " + " ".join(
                  f"{k}={v - launches0[k]}" for k, v in LAUNCHES.items()
                  if v > launches0[k]))
        final = average_params(state) if mesh is None \
            else sharded_average_params(state, mesh, plan)

    # held-out eval
    eval_batch = make_lm_batch(task, args.seed + 999, 0, 10 ** 6,
                               args.batch * args.workers, cfg, device=device)
    with torch.no_grad():
        loss, _ = model.loss(final, eval_batch)
    if logger is not None:
        logger.close()
        say(f"round metrics -> {args.log_every_round}")
    say(f"eval loss {float(loss):.4f}  wall {time.time() - t0:.1f}s")
    if started:
        import torch.distributed as dist
        dist.destroy_process_group()
    return float(loss)


if __name__ == "__main__":
    main()
