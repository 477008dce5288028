#!/usr/bin/env python3
"""Time the port's ``ssd_chunks_seq`` kernel at zamba2-7b's three launch
shapes, for the source tree at ROOT (default: this checkout).

    python3 tools/ssd_shapes.py [ROOT]

The shapes, in chunks of L = 128 with P = N = 64 and H = 112 heads whose
decay spans zamba2's A = 1..8: the 4 x 8160-token prefill, a 512-token
chunk of the chunked prefill and the serving launcher's 64-token chunk.
B_ and C_ are strided column slices, as the model's conv output gives
them. Each time is the median of 20 launches after 3 warm-ups (CUDA
events). Prints the card's name and power limit, then one JSON line:
``{"root": ..., "ms": {"serving": t, "chunk512": t, "launcher64": t}}``.
Run it on two trees in turn (parent, change, change, parent) to compare
them on one card; it needs the card and imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

SHAPES = {"serving": (4, 8160), "chunk512": (1, 512),
          "launcher64": (1, 64)}
H, P, N, L = 112, 64, 64, 128


def _time_ms(fn, reps=20, warm=3):
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


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("ssd_shapes: no CUDA device")
    root = os.path.abspath(argv[0] if argv else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, os.path.join(root, "src"))
    import importlib
    mk = importlib.import_module("repro_torch.kernels.mamba_scan.mamba_scan")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(5)
    decay = torch.linspace(1.0, 8.0, H, device="cuda")
    out = {}
    for name, (Bt, S) in SHAPES.items():
        xh = torch.randn((Bt, S, H, P), generator=gen, device="cuda")
        conv = torch.randn((Bt, S, 2 * N + 64), generator=gen, device="cuda")
        a = -torch.nn.functional.softplus(torch.randn(
            (Bt, S, H), generator=gen, device="cuda")) * decay
        out[name] = _time_ms(lambda: mk.ssd_chunks_seq(
            xh, conv[..., :N], conv[..., N:2 * N], a, L))
        del xh, conv, a
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "ms": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
