#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Card: requires CUDA, prints ``nvidia-smi``'s name and power limit,
   builds the kernels from ``src/repro_torch/kernels/pullpush/csrc``.
2. Kernels: every kernel of the DPPF round against its plain PyTorch
   version at (4, 300), (8, 4097), (5, 2^26 + 3), (32, 65537) and at the
   main path's shape R = 4, n = 1,216,385,024 (yi-6b at LAYERS = 4); then
   times kernel, plain version and the nearest PyTorch call at the main
   shape (CUDA events, median of 20 runs after 3 warm-ups).
3. The slice: yi-6b at full width (d_model 4096, 32/4 heads, d_ff 11008,
   vocab 64000), depth cut to 4 layers, bf16 model over the fp32 flat
   master view; M = 4 workers, simple_avg, alpha 0.1, lam 0.5, tau 4,
   16 steps, seq 64, batch 8 per worker, SGD (momentum 0.9, wd 1e-3).
   Launch counters are zeroed just before and read just after.
4. The launcher: ``repro_torch.launch.train.main`` (``--smoke``) on the
   card.

It prints a ``kernels`` line, the ``{"kernels": [...]}`` record and, last,
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SHAPES = ((4, 300), (8, 4097), (5, 2 ** 26 + 3), (32, 65537))
MAIN_R, MAIN_N = 4, 1_216_385_024
# the slice's depth and local-step learning rate (the launcher's default);
# PERF.md records the numbers of this depth and rate
LAYERS, LR = 4, 0.3
TOL = 1e-4          # max abs error relative to the output's scale
SOURCE = "src/repro_torch/kernels/pullpush/csrc/pullpush.cu"
REPLACES = {
    "fused_round": "src/repro/kernels/pullpush/pullpush.py:194",
    "partial_gram": "src/repro/kernels/pullpush/pullpush.py:298",
    "gram_coef": "src/repro/kernels/pullpush/pullpush.py:162",
    "mix_shard": "src/repro/kernels/pullpush/pullpush.py:319",
}


def _time_ms(fn, reps=20, warm=3):
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _forms(G, T, coef):
    """Pre / post distance forms (zero-sum) of a Gram."""
    R = G.shape[0]
    eye = torch.eye(R, dtype=torch.float32, device=G.device)
    Vu = eye - 1.0 / R
    W = eye + coef[:, None] * (T - eye)
    f = lambda V: torch.sum((V @ G) * V, dim=1)
    return torch.cat([f(Vu), f(Vu @ W)])


class ErrLog:
    """Largest error per kernel, absolute and relative to the output's
    scale (max |plain output|); the relative one is held to TOL."""

    def __init__(self):
        self.abs = {k: 0.0 for k in REPLACES}
        self.rel = {k: 0.0 for k in REPLACES}

    def check(self, name, what, got, want):
        # column chunks: a full-width difference of the main path's view
        # would be one more 19.5 GB temporary
        got, want = got.reshape(got.shape[0], -1), want.reshape(
            want.shape[0], -1)
        err = max(float((g - w).abs().max()) for g, w in zip(
            got.split(1 << 24, dim=-1), want.split(1 << 24, dim=-1)))
        scale = max(float(want.max()), -float(want.min()), 1e-30)
        self.abs[name] = max(self.abs[name], err)
        self.rel[name] = max(self.rel[name], err / scale)
        if not err <= TOL * scale:
            raise AssertionError(f"{name} {what}: max abs err {err:.3e} > "
                                 f"{TOL} x {scale:.3e}")


def _inputs(R, n, gen):
    x = torch.randn((R, n), generator=gen, device="cuda")
    x.mul_(2.0).add_(1.0)
    T = torch.softmax(torch.randn((R, R), generator=gen, device="cuda"),
                      dim=1)
    c0 = torch.linspace(0.1, 0.5, R, device="cuda")
    c1 = torch.linspace(-0.4, -0.1, R, device="cuda")
    return x, T, c0, c1


def check_shape(pk, ref, errs, x, T, c0, c1):
    """Every kernel against its plain version on one input."""
    out, r, G = pk.fused_round(x, T, c0, c1)
    torch.cuda.synchronize()
    p_out, p_r, p_G = ref.fused_round_plain(x, T, c0, c1)
    coef = c0 + c1 / torch.clamp(p_r, min=1e-12)
    errs.check("fused_round", "out", out, p_out)
    errs.check("fused_round", "r", r, p_r)
    errs.check("fused_round", "G forms", _forms(G, T, coef),
               _forms(p_G, T, coef))
    del out
    Gk = pk.partial_gram(x)
    torch.cuda.synchronize()
    errs.check("partial_gram", "G forms", _forms(Gk, T, coef),
               _forms(p_G, T, coef))
    m = pk.mix_shard(x, T, coef)
    torch.cuda.synchronize()
    errs.check("mix_shard", "out", m, p_out)
    del m
    nblk = pk.workspace_blocks(x)
    ws = torch.stack([ref.partial_gram_plain(c)
                      for c in torch.tensor_split(x, nblk, dim=1)])
    g_G, g_r, g_coef = pk.gram_coef(ws, T, c0, c1)
    torch.cuda.synchronize()
    w_G = ws.sum(0)
    w_r, w_coef = ref.gram_coef_plain(w_G, T, c0, c1)
    errs.check("gram_coef", "G", g_G, w_G)
    errs.check("gram_coef", "r", g_r, w_r)
    errs.check("gram_coef", "coef", g_coef, w_coef)
    return p_out, p_r, coef, ws


def phase_kernels(pk, ref):
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = ErrLog()
    for R, n in SHAPES:
        check_shape(pk, ref, errs, *_inputs(R, n, gen))
        print(f"  checked ({R}, {n})")
    R, n = MAIN_R, MAIN_N
    x, T, c0, c1 = _inputs(R, n, gen)
    p_out, _, coef, ws = check_shape(pk, ref, errs, x, T, c0, c1)
    print(f"  checked ({R}, {n}) (main path)")
    del p_out
    out = torch.empty_like(x)
    times = {
        "fused_round": (
            _time_ms(lambda: pk.fused_round(x, T, c0, c1, out=out)),
            _time_ms(lambda: ref.fused_round_plain(x, T, c0, c1, out=out)),
            None),
        "partial_gram": (
            _time_ms(lambda: pk.partial_gram(x)),
            _time_ms(lambda: ref.partial_gram_plain(x)),
            _time_ms(lambda: torch.matmul(x, x.T))),
        "gram_coef": (
            _time_ms(lambda: pk.gram_coef(ws, T, c0, c1)),
            _time_ms(lambda: ref.gram_coef_plain(ws.sum(0), T, c0, c1)),
            None),
        "mix_shard": (
            _time_ms(lambda: pk.mix_shard(x, T, coef, out=out)),
            _time_ms(lambda: ref.mix_shard_plain(x, T, coef, out=out)),
            _time_ms(lambda: torch.matmul(T, x, out=out))),
    }
    nblk = ws.shape[0]
    small = 4 * (R * R + 3 * R)              # T, c0/c1/coef, r
    work = {   # (bytes: inputs once + outputs once, fp32 operations)
        "fused_round": (2 * R * n * 4 + small + R * R * 4,
                        2 * (2 * R * R * n)),
        "partial_gram": (R * n * 4 + R * R * 4, 2 * R * R * n),
        "gram_coef": (nblk * R * R * 4 + small + R * R * 4,
                      nblk * R * R + 4 * R ** 3),
        "mix_shard": (2 * R * n * 4 + small, 2 * R * R * n),
    }
    del x, out, ws
    torch.cuda.empty_cache()
    rows = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        nbytes, ops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs.abs[name], "max_rel_err": errs.rel[name],
            "tol_rel": TOL, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}
    return rows


def phase_slice(pk):
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.core import consensus
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step,
    )
    import repro_torch.train.trainer as trainer_mod

    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=LAYERS)
    M, tau, steps, seq, batch = 4, 4, 16, 64, 8
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, layers {cfg.n_layers}, dtype {cfg.dtype}; "
          f"M={M} tau={tau} steps={steps} seq={seq} batch={batch} "
          f"lr={LR}")
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="flat")
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=LR, total_steps=steps)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=seq)
    gen = torch.Generator(device="cuda").manual_seed(0)

    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()                     # main path: counts from here
    state = init_train_state(model.init, opt, dcfg, M, gen, device="cuda")
    n = state.engine.layout.n
    if n != cfg.param_count():
        raise AssertionError(f"flat view has {n} columns, param_count() "
                             f"{cfg.param_count()}")
    print(f"  flat view ({state.engine.layout.R}, {n}) fp32, "
          f"use_kernel={state.engine.use_kernel}")
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    stages_per_round = sum(
        s[0] == "coef" for s in consensus.lower_stages(
            state.engine, dcfg, clock.lam_at(0))[0])

    # CUDA events around the consensus stage of each round
    apply_round = trainer_mod.consensus.apply_round
    events = []

    def timed_apply_round(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = apply_round(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    trainer_mod.consensus.apply_round = timed_apply_round
    rounds = []
    try:
        for spec in clock.rounds:
            b = make_round_batch(task, 0, M, spec.tau, spec.start, batch,
                                 cfg, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) * 1e3
            cons_ms = events[-1][0].elapsed_time(events[-1][1])
            row = {"round": spec.index, "loss": float(m["train_loss"]),
                   "consensus_dist": float(m["consensus_dist"]),
                   "round_ms": round_ms, "consensus_ms": cons_ms,
                   "local_ms": round_ms - cons_ms}
            rounds.append(row)
            print("  round " + json.dumps(row))
    finally:
        trainer_mod.consensus.apply_round = apply_round
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB)")
    print(f"  launches on the main path {json.dumps(launches)}")
    if not all(math.isfinite(r["loss"]) for r in rounds):
        raise AssertionError("non-finite training loss")
    if not all(r["consensus_dist"] > 0 for r in rounds[1:]):
        raise AssertionError("consensus_dist is 0 after round 0")
    want = stages_per_round * len(rounds)
    if launches["fused_round"] != want:
        raise AssertionError(f"fused_round launched {launches['fused_round']}"
                             f" times for {want} consensus stages")
    for name in REPLACES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if peak > 70e9:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB > 70 GB: set "
                             "LAYERS = 2 and record why in PERF.md")
    later = rounds[1:] or rounds
    print("  mean of rounds 1.. " + json.dumps({
        k: statistics.mean(r[k] for r in later)
        for k in ("round_ms", "consensus_ms", "local_ms")}))
    del state, step
    torch.cuda.empty_cache()
    return launches


def phase_launcher(pk):
    from repro_torch.launch.train import main as train_main
    pk.reset_launches()
    loss = train_main(["--arch", "yi-6b", "--smoke", "--workers", "4",
                       "--tau", "4", "--steps", "16", "--seq", "16",
                       "--batch", "2"])
    if not math.isfinite(loss):
        raise AssertionError(f"launcher eval loss {loss}")
    if pk.LAUNCHES["fused_round"] <= 0:
        raise AssertionError("the launcher's rounds launched no kernel")
    print(f"  launcher eval loss {loss:.4f}, launches "
          f"{json.dumps(dict(pk.LAUNCHES))}")


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — the port's smoke run "
                         "needs the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.pullpush import pullpush as pk
    from repro_torch.kernels.pullpush import ref

    print("phase 1: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    pk.build()
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s "
          f"({pk.build_info['path']})")
    print("\n".join("  " + line for line in pk.build_info["log"].splitlines()
                    if "registers" in line or "spill" in line))

    secs = {"card": time.perf_counter() - t_start}

    print("phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    rows = phase_kernels(pk, ref)
    secs["kernels"] = time.perf_counter() - t0

    print("phase 3: the slice (yi-6b, full width)")
    t0 = time.perf_counter()
    launches = phase_slice(pk)
    secs["slice"] = time.perf_counter() - t0
    for name, row in rows.items():
        row["launches"] = launches[name]

    print("phase 4: the launcher")
    t0 = time.perf_counter()
    phase_launcher(pk)
    secs["launcher"] = time.perf_counter() - t0
    secs["total"] = time.perf_counter() - t_start
    print("phase seconds " + json.dumps(secs))

    record = list(rows.values())
    print("kernels " + json.dumps([
        {k: r[k] for k in ("name", "launches", "ms", "bound_ms",
                           "library_ms")} | {"max_err": r["max_rel_err"]}
        for r in record]))
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
