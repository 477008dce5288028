"""Config inspector: every architecture's resolved config, analytic
parameter counts, memory a card on the production plans, and the decode
policy of each input shape: the pre-flight check before a launch
(counterpart of ``repro/launch/validate.py``, on H100 constants).

  PYTHONPATH=src python -m repro_torch.launch.validate [--arch <id>]

A card is an H100 80GB HBM3 (``HBM_GB``); a node is ``TP`` = 8 cards on
NVLink, the tensor-parallel group. The plans are ``make_production_mesh``'s
on ``CARDS`` = 256 cards (32 nodes, the reference's 256-chip pod): baseline
``M = CARDS / TP`` workers, each over one node; hier ``M = 4`` workers,
each over ``fsdp = CARDS / (4 TP)`` nodes. The formula is the reference's:
parameters in bf16 plus fp32 momentum, split over the cards that shard a
worker. ``describe(name, tp=16, hbm_gb=16.0)`` prints the reference's
text for its v5e pod.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch
from repro_torch.launch import specs as specs_lib

TP = 8             # H100 cards a node (NVLink)
HBM_GB = 80.0      # H100 80GB HBM3
CARDS = 256        # 32 nodes


def plan_shards(tp: int = TP, cards: int = CARDS):
    """``[(label, cards that shard one worker's state)]`` of the two
    production plans."""
    fsdp = cards // (4 * tp)
    return [(f"baseline M={cards // tp} TP={tp}", tp),
            (f"hier M=4 fsdp={fsdp} TP={tp}", tp * fsdp)]


def state_gb(n_params: int, shards: int) -> float:
    """GB a card holds of one worker's parameters (bf16) and momentum
    (fp32) split over ``shards`` cards."""
    return n_params * 2 / shards / 1e9 + n_params * 4 / shards / 1e9


def describe(name: str, *, tp: int = TP, hbm_gb: float = HBM_GB,
             cards: int = CARDS):
    cfg = get_arch(name)
    n = cfg.param_count()
    na = cfg.active_param_count()
    blocks = cfg.blocks()
    kinds = {k: blocks.count(k) for k in sorted(set(blocks))}
    print(f"\n== {name} [{cfg.family}]  ({cfg.source})")
    print(f"   L={cfg.n_layers} d={cfg.d_model} H={cfg.n_heads} "
          f"kv={cfg.n_kv_heads} ff={cfg.d_ff} V={cfg.vocab_size} "
          f"blocks={kinds}")
    print(f"   params={n/1e9:.2f}B active={na/1e9:.2f}B")
    for plan, shards in plan_shards(tp, cards):
        gb = state_gb(n, shards)
        fit = "FITS" if gb <= hbm_gb else "OVER"
        print(f"   {plan}: params(bf16)+mom(fp32) = "
              f"{gb:5.1f} GB/chip [{fit}]")
    for sname, shape in INPUT_SHAPES.items():
        if shape.kind != "decode":
            continue
        w = specs_lib.serve_window_for(cfg, shape)
        buf = specs_lib.buf_len_for(cfg, shape)
        mode = ("recurrent/native" if cfg.is_recurrent and w == 0 else
                f"window={w} ring" if w else "full cache")
        print(f"   {sname}: buf={buf} ({mode})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.validate")
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    args = ap.parse_args(argv)
    for name in ([args.arch] if args.arch else sorted(ARCHS)):
        describe(name)


if __name__ == "__main__":
    main()
