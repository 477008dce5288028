"""Decoder-only LM assembly, config-driven over the block pattern.

Counterpart of ``repro/models/transformer.py`` for the dense families
(``attn``/``local_attn`` patterns: yi-6b, gemma2-2b, internlm2-20b,
qwen2-72b) and the hybrid one (zamba2-7b: ``mamba`` blocks with one
``shared_attn`` block) and the recurrent one (xlstm-350m: ``mlstm`` and
``slstm`` blocks). Parameters keep the reference's trees:

* uniform layout: the layers are stacked on a leading dim under
  ``blocks/stack``;
* cycle layout: ``{"cycle": {"b<j>": stacked over the full pattern
  cycles}, "shared": one attention + MLP block used at every shared_attn
  position, "remainder": {"b<j>": the layers after the last full cycle}}``.

``run_blocks`` is a Python loop where the reference scans. Per-layer
sliding windows follow the pattern (``local_attn`` -> ``sliding_window``,
``attn`` -> 0 = global).

Serving: ``lm_prefill`` / ``lm_make_state`` / ``lm_prefill_chunk`` /
``lm_decode_step`` run the stack over the stacked states (``init_states``:
position-tagged KV caches, one per attention occurrence, Mamba
(ssm, conv) states, mLSTM (C, n, m) and sLSTM (c, n, h, m) tuples), which
the port updates in place. At ``index == 0`` the cache is blank, so
attention over it is exactly causal self-attention over the chunk: there
``_self_attention`` calls the hand-written ``swa_attention`` kernel
(``kernels/swa_attention``). Decode steps and later chunks attend over
the cache with ``attend``, as the reference does in jnp; training keeps
``attend`` too (the kernel has no backward). Mamba blocks route their chunked scan as ``models/ssm.py``
says, sLSTM blocks their recurrence as ``models/xlstm.py`` says. MoE
blocks are not ported yet.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.engine import tree_at, tree_stack
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
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


def _self_attention(p, h, cfg, window, cache=None, index=0):
    """Shared attention plumbing. Returns (attn output, cache). With a
    cache, ``index`` is the chunk's first absolute position (a Python
    int) and the cache is written in place."""
    S = h.shape[1]
    q, k, v = attn.qkv_proj(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    pos = index + torch.arange(S, dtype=torch.int32, device=h.device)
    q = attn.rope(q, pos, cfg.rope_theta)
    k = attn.rope(k, pos, cfg.rope_theta)
    if cache is None:
        o = attn.attend(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                        window=window, cap=cfg.attn_logit_softcap)
        return attn.out_proj(p, o), None
    attn.cache_update(cache, k, v, index)
    if index == 0:
        # blank cache: every slot the write left holds pos -1, so attention
        # over the cache is causal self-attention over the fresh k, v
        o = swa_ops.attention(q, k, v, causal=True, window=window or 0,
                              cap=cfg.attn_logit_softcap)
    else:
        o = attn.attend(q, cache["k"], cache["v"], q_pos=pos,
                        kv_pos=cache["pos"], causal=True, window=window,
                        cap=cfg.attn_logit_softcap,
                        block=attn.serve_block(*q.shape[:3]))
    return attn.out_proj(p, o), cache


def attn_block(p, x, cfg, window=None, cache=None, index=0):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, cache = _self_attention(p["attn"], h, cfg, window, cache, index)
    if "post1" in p:
        o = rms_norm(o, p["post1"], cfg.norm_eps)
    x = x + o
    if "mlp" in p:
        m = mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)
        if "post2" in p:
            m = rms_norm(m, p["post2"], cfg.norm_eps)
        x = x + m
    return x, cache


def _apply_block_inner(kind, p, x, cfg, window, state, index):
    if kind in ("attn", "shared_attn"):
        return attn_block(p, x, cfg, window, state, index)
    if kind == "mamba":
        out, state = ssm_lib.mamba_forward(p, x, cfg, state)
        return x + out, state
    if kind == "mlstm":
        out, state = xlstm_lib.mlstm_forward(p, x, cfg, state)
        return x + out, state
    if kind == "slstm":
        out, state = xlstm_lib.slstm_forward(p, x, cfg, state)
        return x + out, state
    raise _not_ported(f"{kind!r} blocks")


def _apply_block(kind, p, x, cfg, window, state=None, index=0):
    """Dispatch. Returns (x, new_state). With ``cfg.remat`` (and no state)
    the block body is rematerialized in the backward pass (activation
    checkpointing)."""
    if cfg.remat and state is None:
        return torch.utils.checkpoint.checkpoint(
            lambda pp, xx: _apply_block_inner(kind, pp, xx, cfg, window,
                                              None, index)[0], p, x,
            use_reentrant=False), None
    return _apply_block_inner(kind, p, x, cfg, window, state, index)


_INIT = {
    "attn": init_attn_block,
    "shared_attn": init_attn_block,
    "mamba": ssm_lib.init_mamba,
    "mlstm": xlstm_lib.init_mlstm,
    "slstm": xlstm_lib.init_slstm,
}


def _block_state(kind, cfg, batch, buf_len, dtype, *, device):
    """Fresh decode/prefill state for one block."""
    if kind in ("attn", "shared_attn"):
        return attn.init_cache(batch, cfg.n_kv_heads, buf_len, cfg.head_dim,
                               dtype, device=device)
    if kind == "mamba":
        return ssm_lib.init_mamba_state(cfg, batch, dtype, device=device)
    if kind == "mlstm":
        return xlstm_lib.init_mlstm_state(cfg, batch, device=device)
    if kind == "slstm":
        return xlstm_lib.init_slstm_state(cfg, batch, device=device)
    raise _not_ported(f"{kind!r} block states")


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
    kinds = {k for k, _ in _merged_pattern(cfg)}
    if kinds != {"attn"} and not kinds <= {"mamba", "shared_attn"} \
            and not kinds <= {"mlstm", "slstm"}:
        raise _not_ported(f"block pattern {cfg.layer_pattern}")


def _cycles(cfg):
    """(pattern, full cycles, remainder layers) of the cycle layout."""
    pat = _merged_pattern(cfg)
    return (pat,) + divmod(cfg.n_layers, len(pat))


def init_blocks(cfg, gen, dtype, *, device):
    """The layer tree: ``{"stack": {...}}`` (leaves (L, ...)) for uniform
    patterns, ``{"cycle", "shared", "remainder"}`` for cycled ones."""
    _check_supported(cfg)

    def init(kind):
        return _INIT[kind](gen, cfg, dtype, device=device)
    if _layout(cfg) == "uniform":
        return {"stack": tree_stack([init("attn")
                                     for _ in range(cfg.n_layers)])}
    pat, n_cycles, rem = _cycles(cfg)
    params = {"cycle": {f"b{j}": tree_stack([init(kind)
                                              for _ in range(n_cycles)])
                        for j, (kind, _) in enumerate(pat)
                        if kind != "shared_attn"}}
    if any(kind == "shared_attn" for kind, _ in pat):
        params["shared"] = init("shared_attn")
    if rem:
        params["remainder"] = {f"b{j}": init(pat[j][0]) for j in range(rem)
                               if pat[j][0] != "shared_attn"}
    return params


def init_states(cfg, batch, buf_len, dtype, *, device):
    """Fresh stacked states matching ``run_blocks``, in the reference's
    trees: uniform ``{"k", "v": (L, B, buf, nkv, hd), "pos": (L, buf)}``;
    cycled ``{"cycle": {"b<j>": (n_cycles, ...) per position, one KV cache
    per shared-attention occurrence}, "remainder": {"b<j>": ...}}``, an
    xLSTM block's state a tuple of stacked leaves."""
    _check_supported(cfg)

    def one(kind):
        return _block_state(kind, cfg, batch, buf_len, dtype, device=device)
    if _layout(cfg) == "uniform":
        return tree_stack([one("attn")] * cfg.n_layers)
    pat, n_cycles, rem = _cycles(cfg)
    return {"cycle": {f"b{j}": tree_stack([one(kind)] * n_cycles)
                      for j, (kind, _) in enumerate(pat)},
            "remainder": {f"b{j}": one(pat[j][0]) for j in range(rem)}}


def _serve_windows(cfg, serve_window):
    """Per-layer windows; a serving window caps every layer's (global
    layers take it as their window)."""
    ws = _windows(cfg)
    if serve_window:
        ws = [min(w if w else serve_window, serve_window) for w in ws]
    return ws


def run_blocks(blocks, x, cfg, states=None, index=0, serve_window=0):
    """Execute the block stack. Returns (x, states, aux); ``states`` (if
    given) are updated in place, layer by layer."""
    _check_supported(cfg)
    windows = _serve_windows(cfg, serve_window)
    if _layout(cfg) == "uniform":
        for layer, window in enumerate(windows):
            st = None if states is None else tree_at(states, layer)
            x, _ = _apply_block("attn", tree_at(blocks["stack"], layer), x,
                                cfg, window, st, index)
    else:
        pat, n_cycles, rem = _cycles(cfg)
        shared = blocks.get("shared")
        layers = [(f"b{j}", kind, c) for c in range(n_cycles)
                  for j, (kind, _) in enumerate(pat)]
        layers += [(f"b{j}", pat[j][0], None) for j in range(rem)]
        for (name, kind, c), window in zip(layers, windows):
            if c is None:                       # the remainder
                p = shared if kind == "shared_attn" else \
                    blocks["remainder"][name]
                st = None if states is None else states["remainder"][name]
            else:
                p = shared if kind == "shared_attn" else \
                    tree_at(blocks["cycle"][name], c)
                st = None if states is None else \
                    tree_at(states["cycle"][name], c)
            x, _ = _apply_block(kind, p, x, cfg, window, st, index)
    return x, states, torch.zeros((), dtype=torch.float32, device=x.device)


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
    # made on the device: a host tensor copied over would synchronise
    return x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
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


# ---------------------------------------------------------------------------
# Serving lanes (forward only; states are updated in place)
# ---------------------------------------------------------------------------

@torch.no_grad()
def lm_prefill(cfg, params, tokens, buf_len, prefix=None, serve_window=0):
    """Run the prompt through the stack, filling fresh caches.
    Returns (last-token logits, states)."""
    x = _embed(params, cfg, tokens, prefix)
    states = init_states(cfg, x.shape[0], buf_len, x.dtype, device=x.device)
    x, states, _ = run_blocks(params["blocks"], x, cfg, states=states,
                              index=0, serve_window=serve_window)
    return _head(params, cfg, x[:, -1:])[:, 0], states


@torch.no_grad()
def lm_make_state(cfg, params, batch_size, buf_len, prefix=None,
                  serve_window=0):
    """Blank decode states for ``batch_size`` sequences plus the stream
    start index (serving slot-reset / chunked-prefill entry point). Prefix
    inputs (vlm / audio) are not ported, so the start is always 0."""
    if prefix is not None:
        raise _not_ported("prefix embeddings (vlm / audio)")
    del serve_window
    states = init_states(cfg, batch_size, buf_len,
                         params["embed"].dtype, device=params["embed"].device)
    return states, 0


@torch.no_grad()
def lm_prefill_chunk(cfg, params, states, tokens, index, serve_window=0):
    """Run ``tokens`` (B, C) through the stack at absolute positions
    ``index..index+C-1``, updating the (possibly ring) caches in place.
    Returns (last-token logits (B, V), states): feeding a prompt chunk by
    chunk reproduces the one-shot ``lm_prefill``."""
    x = _embed(params, cfg, tokens)
    x, states, _ = run_blocks(params["blocks"], x, cfg, states=states,
                              index=int(index), serve_window=serve_window)
    return _head(params, cfg, x[:, -1:])[:, 0], states


@torch.no_grad()
def lm_decode_step(cfg, params, states, token, index, serve_window=0):
    """One decode step. token: (B, 1) int; index: the token's absolute
    position. Returns (logits (B, V), states)."""
    x = _embed(params, cfg, token)
    x, states, _ = run_blocks(params["blocks"], x, cfg, states=states,
                              index=int(index), serve_window=serve_window)
    return _head(params, cfg, x)[:, 0], states
