"""Decoder-only LM assembly for attention block patterns.

Counterpart of ``repro/models/transformer.py`` for ``attn``/``local_attn``
patterns (the dense families: yi-6b, gemma2-2b, internlm2-20b, qwen2-72b).
Parameters keep the reference's tree: the layers are stacked on a leading
dim under ``blocks/stack``, and ``run_blocks`` is a Python loop over that
dim where the reference scans. Per-layer sliding windows follow the
pattern (``local_attn`` -> ``sliding_window``, ``attn`` -> 0 = global).
MoE, Mamba, xLSTM and shared-attention blocks, and the decode caches, are
not ported yet.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.engine import tree_from_items, tree_items
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_init, init_mlp, mlp, rms_norm, softcap,
)


def _not_ported(what):
    return NotImplementedError(f"not yet ported: {what}")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def init_attn_block(gen, cfg, dtype, *, device):
    d = cfg.d_model
    p = {
        "ln1": torch.zeros((d,), dtype=dtype, device=device),
        "attn": attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, dtype, cfg.qkv_bias,
                                    device=device),
        "ln2": torch.zeros((d,), dtype=dtype, device=device),
    }
    if cfg.d_ff:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device=device)
    if cfg.post_block_norm:
        p["post1"] = torch.zeros((d,), dtype=dtype, device=device)
        p["post2"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _self_attention(p, h, cfg, window):
    S = h.shape[1]
    q, k, v = attn.qkv_proj(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    pos = torch.arange(S, dtype=torch.int32, device=h.device)
    q = attn.rope(q, pos, cfg.rope_theta)
    k = attn.rope(k, pos, cfg.rope_theta)
    o = attn.attend(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                    window=window, cap=cfg.attn_logit_softcap)
    return attn.out_proj(p, o)


def attn_block(p, x, cfg, window=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o = _self_attention(p["attn"], h, cfg, window)
    if "post1" in p:
        o = rms_norm(o, p["post1"], cfg.norm_eps)
    x = x + o
    if "mlp" in p:
        m = mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)
        if "post2" in p:
            m = rms_norm(m, p["post2"], cfg.norm_eps)
        x = x + m
    return x


def _apply_block(kind, p, x, cfg, window):
    """Dispatch; with ``cfg.remat`` the block body is rematerialized in the
    backward pass (activation checkpointing)."""
    if kind != "attn":
        raise _not_ported(f"{kind!r} blocks")
    if cfg.remat:
        return torch.utils.checkpoint.checkpoint(
            lambda pp, xx: attn_block(pp, xx, cfg, window), p, x,
            use_reentrant=False)
    return attn_block(p, x, cfg, window)


# ---------------------------------------------------------------------------
# Pattern machinery
# ---------------------------------------------------------------------------

def _merged_pattern(cfg):
    """Pattern positions as (kind, window); local_attn folds into attn."""
    return [("attn", cfg.sliding_window) if k == "local_attn" else (k, 0)
            for k in cfg.layer_pattern]


def _layout(cfg):
    """uniform: all pattern positions share one structure -> one stack."""
    kinds = {k for k, _ in _merged_pattern(cfg)}
    if kinds <= {"attn"} or kinds == {"moe"}:
        return "uniform"
    return "cycle"


def _windows(cfg):
    pat = _merged_pattern(cfg)
    return [pat[i % len(pat)][1] for i in range(cfg.n_layers)]


def _check_supported(cfg):
    if _layout(cfg) != "uniform" or _merged_pattern(cfg)[0][0] != "attn":
        raise _not_ported(f"block pattern {cfg.layer_pattern}")


def init_blocks(cfg, gen, dtype, *, device):
    """The stacked layer tree ``{"stack": {...}}`` (leaves (L, ...))."""
    _check_supported(cfg)
    layers = [tree_items(init_attn_block(gen, cfg, dtype, device=device))
              for _ in range(cfg.n_layers)]
    stacked = [(path, torch.stack([layer[i][1] for layer in layers]))
               for i, (path, _) in enumerate(layers[0])]
    return {"stack": tree_from_items(stacked)}


def run_blocks(blocks, x, cfg, states=None, index=0, serve_window=0):
    """Execute the block stack. Returns (x, new_states, aux)."""
    if states is not None or serve_window:
        raise _not_ported("decode states (serving)")
    _check_supported(cfg)
    items = tree_items(blocks["stack"])
    for layer, window in enumerate(_windows(cfg)):
        p = tree_from_items([(path, leaf[layer]) for path, leaf in items])
        x = _apply_block("attn", p, x, cfg, window)
    return x, None, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------

def init_lm(cfg, gen, *, device):
    dtype = getattr(torch, cfg.dtype)
    p = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                            device=device),
        "blocks": init_blocks(cfg, gen, dtype, device=device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                  device=device)
    return p


def _embed(params, cfg, tokens, prefix=None):
    if prefix is not None:
        raise _not_ported("prefix embeddings (vlm / audio)")
    x = params["embed"][tokens]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def _head(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    return softcap(logits.to(torch.float32), cfg.final_logit_softcap)


def lm_logits(cfg, params, tokens, prefix=None):
    """Teacher-forced logits over the token positions."""
    x = _embed(params, cfg, tokens, prefix)
    x, _, aux = run_blocks(params["blocks"], x, cfg)
    return _head(params, cfg, x), aux


def cross_entropy(logits, labels):
    """labels < 0 are masked out."""
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          torch.clamp(labels, min=0)[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def lm_loss(cfg, params, batch):
    logits, aux = lm_logits(cfg, params, batch["tokens"],
                            batch.get("prefix"))
    loss = cross_entropy(logits, batch["labels"])
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux}
