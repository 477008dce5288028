"""Rank bodies of the port's tensor-parallel serving tests
(``tests/test_torch_tp_serving.py``): a spawned rank imports torch and
the port only, never JAX."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import MeshPlan
from repro_torch.launch import census
from repro_torch.launch import mesh as mm
from repro_torch.models import build_model, moe as moe_lib
from repro_torch.serving import generate


DROP_CF = 0.5      # a capacity factor at which routing drops entries


def drop_input(cfg):
    """(2, 16, d_model) activations that a MoE layer routes with drops at
    ``DROP_CF``."""
    return torch.randn((2, 16, cfg.d_model),
                       generator=torch.Generator().manual_seed(7))


def serve(model, params, tokens, forced, buf_len):
    """The serving lanes on one prompt batch: (prefill's last logits, the
    decode steps' logits with ``forced`` (B, n) fed one a step, greedy
    ``generate``'s n + 1 tokens)."""
    logits, states = model.prefill(params, {"tokens": tokens}, buf_len)
    steps = [logits]
    S = tokens.shape[1]
    for i in range(forced.shape[1]):
        lg, states = model.decode_step(params, states, forced[:, i:i + 1],
                                       S + i)
        steps.append(lg)
    toks, _ = generate(model, params, {"tokens": tokens},
                       max_new_tokens=forced.shape[1] + 1, buf_len=buf_len)
    return torch.stack(steps, 1), toks


def serve_cases(rank, world, cases):
    """Each case ``(arch, numpy params, tokens, forced, buf_len, ring
    prompt, ring keywords)`` served by this rank of a (1, world) mesh from
    the shard ``shard_params`` cuts of the numpy tree: ``{arch: {"logits",
    "tokens", "ring_tokens", "ring_logits", "collectives", "dropped",
    "kv_heads"}}``, ``collectives`` the prefill's census by kind (count,
    bytes), the ring's from ``generate`` through the chunked prefill."""
    mesh = mm.Mesh(mm.FLAT_AXES, (1, world), device="cpu")
    plan = MeshPlan()
    out = {}
    for arch, np_params, tokens, forced, buf_len, ring, ring_kw in cases:
        cfg = reduced(get_arch(arch))
        model = build_model(cfg, mesh, plan)
        params = mm.shard_params(cfg, np_params, mesh, plan)
        c = census.Census(world)
        with census.counting(c):
            model.prefill(params, {"tokens": tokens}, buf_len)
        logits, toks = serve(model, params, tokens, forced, buf_len)
        rtoks, rlogits = generate(model, params, {"tokens": ring},
                                  max_new_tokens=forced.shape[1], **ring_kw)
        dropped = None
        if cfg.n_experts:
            dropped = int(moe_lib.dropped_entries(
                {"router": params["blocks"]["stack"]["moe"]["router"][0]},
                drop_input(cfg), dataclasses.replace(
                    model.tp.cfg, capacity_factor=DROP_CF), tp=model.tp))
        out[arch] = {"logits": logits, "tokens": toks,
                     "ring_tokens": rtoks, "ring_logits": rlogits,
                     "collectives": {k: (v["count"], v["bytes"])
                                     for k, v in c.collectives.items()
                                     if v["count"]},
                     "dropped": dropped,
                     "kv_heads": model.make_state(params, {
                         "tokens": tokens}, buf_len)[0]["k"].shape[-2]}
    return out
