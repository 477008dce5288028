"""Training launcher: single-device DPPF rounds on any dense LM config.

Counterpart of ``repro/launch/train.py`` for the flat engine with
``--overlap none``. Runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``, as the tests do; it never falls back to the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --workers 4 --tau 4 --alpha 0.1 --lam 0.5 --steps 16 --seq 16 --batch 2

The round loop is the plain ``for spec in clock.rounds`` — the reference's
supervisor with no membership and no chaos plan, bit for bit. The sharded
and overlapped rounds, the supervisor, autotune, checkpoints, the tree
engine and the DDP step are not ported yet: their flags exit with "not yet
ported".
"""
from __future__ import annotations

import argparse
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
    RoundClock, average_params, init_train_state, make_round_step,
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
    ap.add_argument("--engine", default="flat", choices=["tree", "flat"],
                    help="consensus execution engine (only flat is ported)")
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
    # reference flags whose paths are not ported yet
    ap.add_argument("--overlap", default="none",
                    choices=["none", "staleness1", "doublebuf",
                             "staleness_k"])
    for flag in ("--sharded", "--autotune"):
        ap.add_argument(flag, action="store_true", help=NOT_PORTED)
    for flag in ("--mesh", "--chaos", "--tune-plan", "--ckpt"):
        ap.add_argument(flag, default="", help=NOT_PORTED)
    return ap


def main(argv=None, *, device="cuda"):
    ap = _parser()
    args = ap.parse_args(argv)
    for flag, used in (("--sharded", args.sharded), ("--mesh", args.mesh),
                       ("--overlap " + args.overlap, args.overlap != "none"),
                       ("--chaos", args.chaos),
                       ("--autotune", args.autotune),
                       ("--tune-plan", args.tune_plan), ("--ckpt", args.ckpt),
                       ("--engine tree", args.engine != "flat")):
        if used:
            ap.error(f"{flag}: {NOT_PORTED}")
    if not method_registry.get_method(args.consensus).communicates:
        ap.error(f"--method {args.consensus} (the DDP step): {NOT_PORTED}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "launcher on the CPU")

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
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M workers={args.workers} "
          f"tau={args.tau} alpha={args.alpha} lam={args.lam} device={device}")

    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=args.seq)
    dcfg = DPPFConfig(alpha=args.alpha, lam=args.lam, tau=args.tau,
                      consensus=args.consensus, engine=args.engine,
                      lam_schedule=args.lam_schedule,
                      tau_schedule=args.tau_schedule, qsr_beta=args.qsr_beta)
    opt = make_optimizer(args.optimizer, momentum=0.9, weight_decay=1e-3)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    clock = RoundClock.from_config(dcfg, base_lr=args.lr,
                                   total_steps=args.steps, warmup=args.warmup)

    t0 = time.time()
    launches0 = LAUNCHES["fused_round"]
    state = init_train_state(model.init, opt, dcfg, args.workers, gen,
                             device=device)
    step = make_round_step(model.loss, opt, dcfg, clock=clock,
                           sam_rho=args.sam_rho)
    for spec in clock.rounds:
        batch = make_round_batch(task, args.seed, args.workers, spec.tau,
                                 spec.start, args.batch, cfg, device=device)
        state, m = step(state, batch)
        if spec.index % args.log_every == 0:
            print(f"round {spec.index:4d} "
                  f"(step {spec.start + spec.tau:5d} tau {spec.tau:3d}) "
                  f"loss {float(m['train_loss']):.4f} "
                  f"consensus_dist {float(m['consensus_dist']):.3f} "
                  f"lam_t {float(m['lam_t']):.3f}")
    print(f"comm rounds {clock.total_rounds} "
          f"(fixed tau={args.tau} would take {clock.fixed_rounds}; "
          f"all-reduces saved {clock.fixed_rounds - clock.total_rounds}) "
          f"fused_round launches {LAUNCHES['fused_round'] - launches0}")
    final = average_params(state)

    # held-out eval
    eval_batch = make_lm_batch(task, args.seed + 999, 0, 10 ** 6,
                               args.batch * args.workers, cfg, device=device)
    with torch.no_grad():
        loss, _ = model.loss(final, eval_batch)
    print(f"eval loss {float(loss):.4f}  wall {time.time() - t0:.1f}s")
    return float(loss)


if __name__ == "__main__":
    main()
