"""Serving launcher: continuous-batching request streams over SlotEngine
(counterpart of ``repro/launch/serve.py``, with the same flags).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --smoke \
      --requests 8 --max-slots 4 --prompt-len 32 --new-tokens 16 \
      [--static] [--window W] [--chunk C] [--temp 0.8 --topk 40 --topp 0.95]

Runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, as the tests do; it never falls back to the CPU. The
weights are random, drawn from ``--seed``, unless ``--ckpt`` names a
final-params checkpoint (``launch.train --ckpt``, of either package),
which is loaded into the model's tree in its dtypes.
The stream mixes prompt lengths (p/2, p, 2p cycling) so admissions and
evictions interleave mid-decode. A short warm-up stream runs first, so
that first-call costs (the kernel build, allocator growth) are reported
apart from the timed stream.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.models import build_model
from repro_torch.serving import GREEDY, Request, SamplingParams, SlotEngine, serve
from repro_torch.serving.sampling import fold_in


def mixed_lengths(base: int, n: int):
    """Deterministic mixed prompt lengths: p/2, p, 2p cycling."""
    cycle = [max(1, base // 2), base, 2 * base]
    return [cycle[i % 3] for i in range(n)]


def build_requests(cfg, key: int, lens, new_tokens):
    rng = np.random.default_rng(key)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, (l,)),
                    max_new_tokens=new_tokens)
            for i, l in enumerate(lens)]


def _parser():
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma2-2b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window serving variant (ring buffer)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="streaming-prefill chunk (0 = auto)")
    ap.add_argument("--buf-len", type=int, default=0,
                    help="cache positions per slot (0 = auto)")
    ap.add_argument("--temp", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--topk", type=int, default=0)
    ap.add_argument("--topp", type=float, default=1.0)
    ap.add_argument("--static", action="store_true",
                    help="static batching baseline (admission barrier)")
    ap.add_argument("--ckpt", default="",
                    help="final-params checkpoint to serve (launch.train "
                         "--ckpt)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, *, device="cuda"):
    args = _parser().parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "launcher on the CPU")

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    if args.ckpt:
        params, _ = load_pytree(args.ckpt, params)
    key = args.seed

    sampling = (GREEDY if args.temp == 0.0 else SamplingParams(
        temperature=args.temp, top_k=args.topk, top_p=args.topp))
    lens = mixed_lengths(args.prompt_len, args.requests)
    buf = args.buf_len or (args.window + (args.chunk or 1) if args.window
                           else max(lens) + args.new_tokens)
    engine = SlotEngine(model, params, max_slots=args.max_slots,
                        buf_len=buf, window=args.window, chunk=args.chunk,
                        sampling=sampling)

    # warm-up stream: every lane, the chunked-prefill lane via a long prompt
    warm_lens = [max(lens), min(lens)][:min(2, args.requests)]
    warm = build_requests(cfg, fold_in(key, 1), warm_lens, 2)
    t0 = time.perf_counter()
    serve(engine, warm, mode="continuous", key=fold_in(key, 2))
    warm_s = time.perf_counter() - t0

    reqs = build_requests(cfg, fold_in(key, 3), lens, args.new_tokens)
    mode = "static" if args.static else "continuous"
    report = serve(engine, reqs, mode=mode, key=fold_in(key, 4))

    print(f"arch={cfg.name} mode={mode} slots={args.max_slots} "
          f"requests={args.requests} lens={lens} new={args.new_tokens} "
          f"window={args.window} buf={buf} chunk={engine.chunk} "
          f"sampling={'greedy' if sampling.greedy else sampling} "
          f"device={device}")
    print(f"warm-up stream: {warm_s:.2f}s; lane signatures "
          f"{engine.compile_cache_sizes()}")
    print(f"timed: {report.tok_s:.1f} tok/s over {report.steps} steps, "
          f"occupancy {report.occupancy:.2f}, "
          f"ttft mean {report.ttft_mean_s * 1e3:.1f}ms, "
          f"{report.generated} tokens in {report.wall_s:.2f}s")
    print("sample rid=0:", report.results[0].tokens[:16])
    return report


if __name__ == "__main__":
    main()
