"""Dry-run planner over H100 nodes: trace every (arch x input shape x node
count) step on ``meta`` tensors, count its work and traffic, and write one
JSON record a combination for the roofline report (counterpart of
``repro/launch/dryrun.py``, which compiles on 512 forced host devices).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --nodes 1,32 [--plan baseline|hier|opt|hier_opt] \\
      [--mode train|ddp|prefill|decode] [--tau 4] [--overlap none|...] \\
      [--staleness K] [--all] [--out results/dryrun_torch]

It runs on the CPU and allocates nothing: the state, the batch and every
intermediate are ``meta`` tensors, the mesh is rank 0's ``VirtualMesh``
of ``launch.mesh.make_production_mesh(nodes, plan=...)``, and
``launch.roofline.analyze_step`` counts the call (matmul flops, bytes
before fusion, the collectives, each kernel's calls at its ``cost()``).

* **train / ddp**: the port's sharded round on the flat engine
  (``train.make_sharded_round_step``), the only step the port shards:
  rank 0's rows and column shard of the (R, n) view, the local steps of
  its rows at full width (the port gathers a worker's columns for its
  steps; it has no tensor-parallel compute), the boundary's gathers and
  all-reduces over the virtual groups. The overlap modes count a stale
  round (their fill rounds run first, uncounted). The port has no sharded
  DDP step, so ``ddp`` counts the sharded round at tau 1 on the per-step
  batch: one local step and one exact consensus a step, DDP's cadence.
* **prefill / decode**: one replica over each node's ``model`` axis (8
  cards, tensor-parallel serving: ``models/parallel.py``), traced on rank
  0: its shard of the parameters and of the KV cache on ``meta``, the
  model-axis all-reduces and all-gathers of the forward recorded with
  the census. The shape's batch goes over ``data`` (one replica a node)
  where the reference's ``data_ok`` rule allows
  (``repro/launch/dryrun.py:180, :200-201``), else every replica takes
  the whole batch. ``fits`` says whether the rank's shard, its inputs and
  the trace's peak fit one card's 80 GB; ``placed_apart`` lists the
  leaves whose split is not the reference's (``launch.mesh.placed_apart``:
  replicated KV heads, the shared expert). The reference's
  context-parallel ``long_500k`` (its KV buffer over ``data``) is not
  ported: that shape's batch of one is served whole by every replica.

Plans: ``baseline`` and ``hier`` are the production meshes; ``opt`` /
``hier_opt`` also run the chunked mLSTM (``xlstm_chunk = 256``), the bf16
MoE combine and bf16 momentum (the reference's ``_cfg_for``). The
reference's ``seqshard`` plan shards activations over GSPMD and has no
counterpart here.

Records go to ``results/dryrun_torch/<arch>_<shape>_<nodes>n_<mode>_<plan>
[_<overlap>].json`` with the reference's keys (``lower_s`` is the trace's
seconds, ``compile_s`` 0: nothing is compiled; ``cost_raw_xla`` holds the
trace's own flops and bytes) plus ``engine``, ``kernels``, ``nodes``,
``mesh_shape`` and, for serving, ``fits``, ``replicas``,
``batch_per_replica``, ``param_bytes_per_card`` and ``placed_apart``. ``memory`` holds the specs'
``argument_size_in_bytes`` / ``output_size_in_bytes`` and, as
``temp_size_in_bytes``, the dispatch trace's peak of live bytes (not an
allocator's). A record that exists is skipped.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCHS, DPPFConfig, INPUT_SHAPES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rf
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.validate import HBM_GB
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.serving import make_serve_step
from repro_torch.train import (
    RoundClock, init_train_state, make_sharded_round_step, shard_train_state,
)

# the LR / step budget every train-mode dry-run traces against (and the
# clock of the round-plan table)
TRAIN_LR, TRAIN_STEPS = 0.1, 1000
PLANS = ("baseline", "hier", "opt", "hier_opt")
MODES = ("train", "ddp", "prefill", "decode")
OVERLAPS = ("none", "staleness1", "doublebuf", "staleness_k")
OUT = os.path.join("results", "dryrun_torch")


def _mesh_for(plan_name: str, nodes: int):
    kind = "hier" if plan_name in ("hier", "hier_opt") else "baseline"
    return mesh_lib.make_production_mesh(nodes, plan=kind)


def _cfg_for(arch, plan_name, train: bool):
    """``opt`` plans: the chunked mLSTM and the bf16 MoE combine (bf16
    momentum in ``build_train``)."""
    cfg = ARCHS[arch]
    if train:
        cfg = dataclasses.replace(cfg, remat=True)
    if plan_name in ("opt", "hier_opt"):
        cfg = dataclasses.replace(cfg, xlstm_chunk=256,
                                  moe_combine_dtype="bfloat16")
    return cfg


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _state_tree(state):
    return [state.params, state.opt, state.cstate, state.snap]


def _rank_rows(batch, mesh, plan):
    """Rank 0's worker rows of a ``(tau, M, ...)`` batch."""
    M = next(iter(batch.values())).shape[1]
    m_loc = M // mesh.axis_size(plan.worker_axes)
    first = mesh.lin_index(plan.worker_axes) * m_loc
    return {k: v[:, first:first + m_loc] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# each workload kind: (step, args, cfg, info) on rank 0's view of the mesh
# ---------------------------------------------------------------------------

def build_train(arch, shape, mesh, plan, *, ddp=False, tau=4,
                plan_name="baseline", overlap="none", staleness=1):
    cfg = _cfg_for(arch, plan_name, train=True)
    model = build_model(cfg)
    if ddp:
        tau, overlap = 1, "none"
    dcfg = DPPFConfig(tau=tau, consensus="simple_avg", engine="flat",
                      overlap=overlap, staleness=staleness)
    opt = make_optimizer(
        "sgd", momentum=0.9, weight_decay=1e-3,
        state_dtype="bfloat16" if plan_name in ("opt", "hier_opt")
        else "float32")
    M = mesh.axis_size(plan.worker_axes)
    clock = RoundClock.from_config(dcfg, base_lr=TRAIN_LR,
                                   total_steps=TRAIN_STEPS)
    state = init_train_state(model.init, opt, dcfg, M, None, device="meta")
    state = shard_train_state(state, mesh, plan, dcfg=dcfg)
    step = make_sharded_round_step(model.loss, opt, dcfg, mesh=mesh,
                                   plan=plan, clock=clock)
    batch = specs_lib.input_specs(cfg, shape, plan,
                                  "ddp" if ddp else "train", M, tau)
    if ddp:                          # one step a round: (1, M, B, S)
        batch = {k: v[None] for k, v in batch.items()}
    batch = _rank_rows(batch, mesh, plan)
    fill = staleness if overlap == "staleness_k" else \
        int(overlap != "none")
    for _ in range(fill):            # the fill rounds, uncounted
        state, _ = step(state, batch)
    info = {"n_workers": M, "engine": "flat engine, sharded round "
            "(kernel route)" + (", tau 1 (ddp cadence)" if ddp else ""),
            "fill_rounds": fill}
    return step, (state, batch), cfg, info


def _serve_shape(shape, mesh, plan, *, decode):
    """The shape one replica serves and the replicas: the batch over the
    ``data`` axis where the reference's ``data_ok`` allows (for decode
    also a batch at least as large as the axis), else the whole batch on
    every replica."""
    d = mesh.axis_size(plan.worker_axes)
    data_ok = shape.global_batch % d == 0 and \
        (not decode or shape.global_batch >= d)
    if not data_ok:
        return shape, 1
    return dataclasses.replace(shape, global_batch=shape.global_batch // d),\
        d


def _serve_info(cfg, mesh, plan, local, replicas):
    m = mesh_lib.model_group(mesh, plan).size
    return {"engine": f"one replica over model = {m}", "replicas": replicas,
            "batch_per_replica": local.global_batch,
            "placed_apart": {p: [ref, got] for p, (ref, got) in
                             mesh_lib.placed_apart(cfg, m).items()}}


def build_prefill(arch, shape, mesh, plan, plan_name="baseline"):
    cfg = _cfg_for(arch, plan_name, train=False)
    model = build_model(cfg, mesh, plan)
    local, replicas = _serve_shape(shape, mesh, plan, decode=False)
    params = specs_lib.param_specs(cfg, mesh, plan)
    batch = specs_lib.prefill_batch_specs(cfg, local)
    buf = specs_lib.buf_len_for(cfg, local)

    def prefill(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, buf)
    info = _serve_info(cfg, mesh, plan, local, replicas)
    return prefill, (params, batch), cfg, info


def build_decode(arch, shape, mesh, plan, plan_name="baseline"):
    cfg = _cfg_for(arch, plan_name, train=False)
    model = build_model(cfg, mesh, plan)
    local, replicas = _serve_shape(shape, mesh, plan, decode=True)
    window = specs_lib.serve_window_for(cfg, local)
    serve_step = make_serve_step(model, window=window)
    params = specs_lib.param_specs(cfg, mesh, plan)
    token, _, states = specs_lib.decode_step_specs(cfg, local, params, mesh,
                                                   plan)
    index = local.seq_len - 1        # the last position: a full cache

    def decode(params, states, token):
        with torch.no_grad():
            return serve_step(params, states, token, index)
    info = dict(_serve_info(cfg, mesh, plan, local, replicas), index=index)
    return decode, (params, states, token), cfg, info


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def record_tag(arch, shape_name, nodes, mode, plan_name, overlap="none",
               staleness=1):
    tag = f"{arch}_{shape_name}_{nodes}n_{mode}_{plan_name}"
    if overlap == "staleness_k":
        tag += f"_{overlap}{staleness}"
    elif overlap != "none":
        tag += f"_{overlap}"
    return tag


def run_one(arch, shape_name, nodes, *, mode=None, plan_name="baseline",
            tau=4, out_dir=OUT, overlap="none", staleness=1):
    shape = INPUT_SHAPES[shape_name]
    mesh, plan = _mesh_for(plan_name, nodes)
    mode = mode or ("train" if shape.kind == "train" else shape.kind)
    if overlap != "none" and mode != "train":
        raise ValueError("--overlap applies to train-mode dry-runs only")

    t0 = time.time()
    if mode in ("train", "ddp"):
        fn, args, cfg, info = build_train(
            arch, shape, mesh, plan, ddp=mode == "ddp", tau=tau,
            plan_name=plan_name, overlap=overlap, staleness=staleness)
    elif mode == "prefill":
        fn, args, cfg, info = build_prefill(arch, shape, mesh, plan,
                                            plan_name)
    else:
        fn, args, cfg, info = build_decode(arch, shape, mesh, plan,
                                           plan_name)
    t_build = time.time() - t0
    got = []
    ana = rf.analyze_step(lambda *a: got.append(fn(*a)), *args, mesh=mesh)
    t_trace = time.time() - t0 - t_build
    arg_bytes = _nbytes([_state_tree(a) if hasattr(a, "params") else a
                         for a in args])
    out = got[0]
    out_bytes = _nbytes([_state_tree(o) if hasattr(o, "params") else o
                         for o in out])
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": ana["peak_live_bytes"],
           "note": "temp_size_in_bytes is the dispatch trace's peak of "
                   "live bytes, not an allocator's"}
    coll = ana["collectives"]
    steps = 1 if mode == "ddp" else tau
    scale = 1.0 / steps if mode in ("train", "ddp") else 1.0
    terms = rf.roofline(ana["flops"], ana["bytes"], coll,
                        seconds_scale=scale)
    mf = rf.model_flops(cfg, shape, mode=mode)
    chips = mesh.size
    rec = {
        "arch": arch, "shape": shape_name, "mesh": f"{nodes}n",
        "mode": mode, "plan": plan_name, "chips": chips, "tau": steps,
        "overlap": overlap,
        "n_workers": info.get("n_workers"),
        "lower_s": round(t_trace, 2), "compile_s": 0.0,
        "memory": mem,
        "cost_raw_xla": {"flops": ana["flops"],
                         "bytes_accessed": ana["bytes"]},
        "hlo_flops_per_dev": ana["flops"], "hlo_bytes_per_dev": ana["bytes"],
        "collectives": coll,
        "collective_axis_bytes": ana["collective_axis_bytes"],
        "roofline": dict(terms),
        "model_flops_total": mf,
        "model_flops_per_chip_step": mf / chips,
        "useful_flop_ratio": (mf / chips) / max(ana["flops"] * scale, 1.0),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "engine": info["engine"], "kernels": ana["kernels"],
        "nodes": nodes, "mesh_shape": dict(mesh.shape),
        "build_s": round(t_build, 2),
    }
    if mode in ("train", "ddp"):
        rec["overlap_model"] = rf.overlap_model(
            terms, ana["collective_axis_bytes"], R=info["n_workers"],
            seconds_scale=scale)
        rec["staleness"] = staleness if overlap == "staleness_k" else None
    else:
        rec.update(replicas=info["replicas"],
                   batch_per_replica=info["batch_per_replica"],
                   param_bytes_per_card=_nbytes(args[0]),
                   placed_apart=info["placed_apart"],
                   fits=arg_bytes + ana["peak_live_bytes"]
                   <= HBM_GB * 1e9)
    os.makedirs(out_dir, exist_ok=True)
    tag = record_tag(arch, shape_name, nodes, mode, plan_name, overlap,
                     staleness)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[OK] {tag}: trace={t_trace:.1f}s "
          f"flops/dev={ana['flops']:.3e} "
          f"coll={sum(v['bytes'] for v in coll.values()):.3e}B "
          f"bottleneck={terms['bottleneck']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--nodes", default="1",
                    help="H100 nodes of 8 cards, comma-separated (e.g. "
                         "1,32)")
    ap.add_argument("--mode", default=None, choices=[None, *MODES])
    ap.add_argument("--plan", default="baseline", choices=PLANS)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--overlap", default="none", choices=OVERLAPS,
                    help="trace the overlapped sharded round (train-mode "
                         "combinations only); every train record also "
                         "carries the modelled exact / staleness1 / "
                         "doublebuf / staleness-k rounds (overlap_model)")
    ap.add_argument("--staleness", type=int, default=1,
                    help="staleness_k: snapshot-ring depth k")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    try:
        node_counts = [int(x) for x in args.nodes.split(",") if x]
    except ValueError:
        ap.error("--nodes expects comma-separated ints (e.g. 1,32)")

    # round-plan report: the clock every train-mode combination traces
    # against, tau from the CLI, the dry-run's LR budget
    print(RoundClock(total_steps=TRAIN_STEPS, tau=args.tau,
                     base_lr=TRAIN_LR, overlap=args.overlap,
                     staleness=args.staleness).plan_table())
    print()

    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or not args.shape
              else [args.shape])
    failures = []
    for nodes in node_counts:
        for a in archs:
            for s in shapes:
                tag = f"{a}_{s}_{nodes}n"
                mode = (args.mode or
                        ("train" if INPUT_SHAPES[s].kind == "train"
                         else INPUT_SHAPES[s].kind))
                if args.overlap != "none" and mode != "train":
                    print(f"[skip] {tag} (--overlap is train-only)")
                    continue
                path = os.path.join(args.out, record_tag(
                    a, s, nodes, mode, args.plan, args.overlap,
                    args.staleness) + ".json")
                if os.path.exists(path):
                    print(f"[skip] {tag} (cached)")
                    continue
                try:
                    run_one(a, s, nodes, mode=args.mode,
                            plan_name=args.plan, tau=args.tau,
                            out_dir=args.out, overlap=args.overlap,
                            staleness=args.staleness)
                except Exception as e:  # noqa: BLE001 — reported, run goes on
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
