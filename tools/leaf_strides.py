#!/usr/bin/env python3
"""Time ``pullpush_fused``'s two leaf kernels (``leaf_gram``, ``leaf_mix``)
and the flat view's ``partial_gram`` / ``mix_shard`` on trees and views
whose rows lie at different strides, to see whether the distance between a
stacked leaf's worker rows sets the kernels' bandwidth.

    python3 tools/leaf_strides.py

Cases, M = 4 workers each: yi-6b's stacked bf16 tree at 4 layers (its
largest rows lie 2^22-multiples of bytes apart); one bf16 leaf of 2^28
columns (rows 2^29 bytes apart) and one of 2^28 + 49,380 columns (rows
8 bytes off any larger power of two); the fp32 (4, n) view at n = 2^28
and at n = 2^28 + 49,380. Each time is the median of 20 launches after 3
warm-ups (CUDA events), beside the bytes bound at 3.35 TB/s. Prints the
card's name and power limit, then one JSON line per case. It needs the
card and imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM = 3.35e12
M = 4
ODD = 49_380          # a multiple of 4 that is no larger power of two


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


def _leaf_case(pk, leaves):
    """The two leaf launches on one prepared table, timed apart."""
    dev = leaves[0].device
    T = torch.full((M, M), 1.0 / M, device=dev)
    c0 = torch.full((M,), 0.1, device=dev)
    c1 = torch.full((M,), -0.5, device=dev)
    table = pk.leaf_table(leaves)
    gram, mix, *_ = pk._leaf_launches(leaves, table, T, c0, c1, 1e-12)
    nbytes = sum(l.numel() * l.element_size() for l in leaves)
    g, m = _time_ms(gram), _time_ms(mix)
    return {"n": table.n, "vec": table.vec, "leaves": len(leaves),
            "gram_ms": g, "gram_bound_share": nbytes / HBM * 1e3 / g,
            "mix_ms": m, "mix_bound_share": 2 * nbytes / HBM * 1e3 / m}


def _flat_case(pk, n):
    x = torch.randn((M, n), device="cuda")
    T = torch.full((M, M), 1.0 / M, device="cuda")
    coef = torch.full((M,), 0.5, device="cuda")
    out = torch.empty_like(x)
    g = _time_ms(lambda: pk.partial_gram(x))
    m = _time_ms(lambda: pk.mix_shard(x, T, coef, out=out))
    nbytes = x.numel() * 4
    return {"n": n, "gram_ms": g, "gram_bound_share": nbytes / HBM * 1e3 / g,
            "mix_ms": m, "mix_bound_share": 2 * nbytes / HBM * 1e3 / m}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("leaf_strides: needs the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import tree_items
    from repro_torch.kernels.pullpush import pullpush as pk
    from repro_torch.models import build_model
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(14)
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=4)
    leaves = [leaf[None].expand((M,) + leaf.shape).to(torch.bfloat16)
              .contiguous() for _, leaf in tree_items(
                  build_model(cfg).init(gen, "cuda"))]
    print(json.dumps({"case": "yi-6b stacked bf16, 4 layers",
                      **_leaf_case(pk, leaves)}))
    del leaves
    torch.cuda.empty_cache()
    for n in (1 << 28, (1 << 28) + ODD):
        leaf = torch.randn((M, n), device="cuda").to(torch.bfloat16)
        print(json.dumps({"case": f"one bf16 leaf (4, {n})",
                          **_leaf_case(pk, [leaf])}))
        del leaf
        torch.cuda.empty_cache()
    for n in (1 << 28, (1 << 28) + ODD):
        print(json.dumps({"case": f"fp32 view (4, {n})",
                          **_flat_case(pk, n)}))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
