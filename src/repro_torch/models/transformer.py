"""Decoder-only LM assembly, config-driven over the block pattern.

Counterpart of ``repro/models/transformer.py`` for every decoder-only
family: dense (``attn``/``local_attn`` patterns: yi-6b, gemma2-2b,
internlm2-20b, qwen2-72b; internvl2-2b with its stubbed ViT patch
embeddings as a prefix), MoE (``moe`` blocks: dbrx-132b,
llama4-scout-17b-a16e), hybrid (zamba2-7b: ``mamba`` blocks with one
``shared_attn`` block) and recurrent (xlstm-350m: ``mlstm`` and ``slstm``
blocks). Parameters keep the reference's trees:

* uniform layout: the layers are stacked on a leading dim under
  ``blocks/stack``;
* cycle layout: ``{"cycle": {"b<j>": stacked over the full pattern
  cycles}, "shared": one attention + MLP block used at every shared_attn
  position, "remainder": {"b<j>": the layers after the last full cycle}}``.

``run_blocks`` is a Python loop where the reference scans; it sums the
blocks' aux losses (MoE routing) over the layers, as the reference's scan
carries them. Per-layer sliding windows follow the pattern (``local_attn``
-> ``sliding_window``, ``attn`` -> 0 = global). A prefix (vlm / audio
decoder-only) is concatenated after the scaled token embeddings and takes
positions ``0..P-1``; the logits cover the tokens only.

Serving: ``lm_prefill`` / ``lm_make_state`` / ``lm_prefill_chunk`` /
``lm_decode_step`` run the stack over the stacked states (``init_states``:
position-tagged KV caches, one per attention occurrence, Mamba
(ssm, conv) states, mLSTM (C, n, m) and sLSTM (c, n, h, m) tuples), which
the port updates in place. At ``index == 0`` the cache is blank, so
attention over it is exactly causal self-attention over the chunk: there
``_self_attention`` calls the hand-written ``swa_attention`` kernel
(``kernels/swa_attention``). Decode steps and later chunks attend over
the cache with ``attend``, as the reference does in jnp; training keeps
``attend`` too (the kernel has no backward). Mamba blocks route their
chunked scan as ``models/ssm.py`` says, sLSTM blocks their recurrence as
``models/xlstm.py`` says, MoE blocks their routing as ``models/moe.py``
says. ``lm_make_state`` runs a prefix through the stack at index 0 and
returns start ``P``, so the serving lanes stream raw tokens only.

Every block and lane takes ``tp``, a ``models.parallel.TP``: then ``cfg``
is the rank's config, the parameters and states are its shards, and the
embedding, each attention output and MLP, and the head meet the rank's
``model`` group (that module says where). ``tp=None`` is the
one-device model.

``lm_decode_step``'s ``index`` is a Python int (one position for the whole
batch: ``generate``) or a (B,) tensor (the slot engine's batched step:
each row its own position, cache slot, ``pos`` tags, band and MoE routing
group, as the reference's vmap over slots gives; the (B,) bool ``active``
freezes the rows it marks False, every state of theirs left as it was).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.engine import (
    tree_at, tree_from_items, tree_items, tree_stack,
)
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (
    embed_init, init_mlp, mlp, rms_norm, softcap,
)


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


def init_moe_block(gen, cfg, dtype, *, device):
    d = cfg.d_model
    return {
        "ln1": torch.zeros((d,), dtype=dtype, device=device),
        "attn": attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, dtype, cfg.qkv_bias,
                                    device=device),
        "ln2": torch.zeros((d,), dtype=dtype, device=device),
        "moe": moe_lib.init_moe(gen, cfg, dtype, device=device),
    }


def _self_attention(p, h, cfg, window, cache=None, index=0, active=None,
                    tp=None):
    """Shared attention plumbing. Returns (attn output, cache). With a
    cache, ``index`` is the chunk's first absolute position (a Python
    int, or a (B,) tensor of per-row positions for one token a row) and
    the cache is written in place (only in the ``active`` rows). Under a
    ``TP`` ``cfg`` is the rank's: its heads, its cache, its part of
    ``wo`` summed over the group."""
    S = h.shape[1]
    q, k, v = attn.qkv_proj(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    pos = attn.positions(index, S, h.device)
    q = attn.rope(q, pos, cfg.rope_theta)
    k = attn.rope(k, pos, cfg.rope_theta)
    if cache is None:
        o = attn.attend(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                        window=window, cap=cfg.attn_logit_softcap)
        return attn.out_proj(p, o, tp), None
    attn.cache_update(cache, k, v, index, active)
    if _blank_start(index):
        # blank cache: every slot the write left holds pos -1, so attention
        # over the cache is causal self-attention over the fresh k, v
        o = swa_ops.attention(q, k, v, causal=True, window=window or 0,
                              cap=cfg.attn_logit_softcap)
    else:
        o = attn.attend(q, cache["k"], cache["v"], q_pos=pos,
                        kv_pos=cache["pos"], causal=True, window=window,
                        cap=cfg.attn_logit_softcap,
                        block=attn.serve_block(*q.shape[:3]))
    return attn.out_proj(p, o, tp), cache


def _blank_start(index):
    """Whether a chunk at ``index`` meets a blank cache: an int 0. A
    per-row index (the slot engine's decode step) always attends over the
    cache, as the reference's decode does."""
    return not torch.is_tensor(index) and index == 0


def _step_index(index):
    """A decode step's index: a (B,) tensor of per-row positions as it
    is, anything else as a Python int."""
    if torch.is_tensor(index) and index.dim() == 1:
        return index
    return int(index)


def attn_block(p, x, cfg, window=None, cache=None, index=0, active=None,
               tp=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, cache = _self_attention(p["attn"], h, cfg, window, cache, index,
                               active, tp)
    if "post1" in p:
        o = rms_norm(o, p["post1"], cfg.norm_eps)
    x = x + o
    if "mlp" in p:
        m = mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act, tp)
        if "post2" in p:
            m = rms_norm(m, p["post2"], cfg.norm_eps)
        x = x + m
    return x, cache


def moe_block(p, x, cfg, window=None, cache=None, index=0, active=None,
              tp=None):
    """Attention, then the MoE MLP. Returns (x, cache, aux). A per-row
    ``index`` routes each row as its own group."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, cache = _self_attention(p["attn"], h, cfg, window, cache, index,
                               active, tp)
    x = x + o
    # without a group, the one-device call as it always was
    split = {} if tp is None else {"tp": tp}
    m, aux = moe_lib.moe_mlp(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps),
                             cfg, per_row=torch.is_tensor(index), **split)
    return x + m, cache, aux


def _apply_block_inner(kind, p, x, cfg, window, state, index, active,
                       tp=None):
    """(x, new_state, aux): aux is None for blocks that have none."""
    if kind in ("attn", "shared_attn"):
        return attn_block(p, x, cfg, window, state, index, active,
                          tp) + (None,)
    if kind == "moe":
        return moe_block(p, x, cfg, window, state, index, active, tp)
    if kind == "mamba":
        out, state = ssm_lib.mamba_forward(p, x, cfg, state, active)
    elif kind == "mlstm":
        out, state = xlstm_lib.mlstm_forward(p, x, cfg, state, active)
    elif kind == "slstm":
        out, state = xlstm_lib.slstm_forward(p, x, cfg, state, active)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return x + out, state, None


def _apply_block(kind, p, x, cfg, window, state=None, index=0, active=None,
                 tp=None):
    """Dispatch. Returns (x, new_state, aux). With ``cfg.remat`` (and no
    state) the block body is rematerialized in the backward pass
    (activation checkpointing); a MoE block's aux leaves the checkpoint
    beside x."""
    if cfg.remat and state is None:
        def body(pp, xx):
            out, _, aux = _apply_block_inner(kind, pp, xx, cfg, window,
                                             None, index, None, tp)
            return out if aux is None else (out, aux)
        res = torch.utils.checkpoint.checkpoint(body, p, x,
                                                use_reentrant=False)
        return (res[0], None, res[1]) if kind == "moe" else (res, None, None)
    return _apply_block_inner(kind, p, x, cfg, window, state, index, active,
                              tp)


_INIT = {
    "attn": init_attn_block,
    "shared_attn": init_attn_block,
    "moe": init_moe_block,
    "mamba": ssm_lib.init_mamba,
    "mlstm": xlstm_lib.init_mlstm,
    "slstm": xlstm_lib.init_slstm,
}


def _block_state(kind, cfg, batch, buf_len, dtype, *, device):
    """Fresh decode/prefill state for one block."""
    if kind in ("attn", "shared_attn", "moe"):
        return attn.init_cache(batch, cfg.n_kv_heads, buf_len, cfg.head_dim,
                               dtype, device=device)
    if kind == "mamba":
        return ssm_lib.init_mamba_state(cfg, batch, dtype, device=device)
    if kind == "mlstm":
        return xlstm_lib.init_mlstm_state(cfg, batch, device=device)
    if kind == "slstm":
        return xlstm_lib.init_slstm_state(cfg, batch, device=device)
    raise ValueError(f"unknown block kind {kind!r}")


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


def _cycles(cfg):
    """(pattern, full cycles, remainder layers) of the cycle layout."""
    pat = _merged_pattern(cfg)
    return (pat,) + divmod(cfg.n_layers, len(pat))


def stack_init(make, n):
    """``tree_stack([make() for _ in range(n)])`` without holding the n
    trees at once: the stack is allocated after the first tree and each
    tree is copied in as it is made (the same draws in the same order).
    One full-width MoE layer is gigabytes."""
    tree = make()
    out = [(path, torch.empty((n,) + tuple(leaf.shape), dtype=leaf.dtype,
                              device=leaf.device))
           for path, leaf in tree_items(tree)]
    for i in range(n):
        if i:
            tree = make()
        for (_, dst), (_, leaf) in zip(out, tree_items(tree)):
            if dst.device.type != "meta":
                dst[i].copy_(leaf)
        tree = None
    return tree_from_items(out)


def init_blocks(cfg, gen, dtype, *, device):
    """The layer tree: ``{"stack": {...}}`` (leaves (L, ...)) for uniform
    patterns, ``{"cycle", "shared", "remainder"}`` for cycled ones."""
    def init(kind):
        return _INIT[kind](gen, cfg, dtype, device=device)
    pat, n_cycles, rem = _cycles(cfg)
    if _layout(cfg) == "uniform":
        return {"stack": stack_init(lambda: init(pat[0][0]), cfg.n_layers)}
    params = {"cycle": {f"b{j}": stack_init(lambda: init(kind), n_cycles)
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
    def one(kind):
        return _block_state(kind, cfg, batch, buf_len, dtype, device=device)
    pat, n_cycles, rem = _cycles(cfg)
    if _layout(cfg) == "uniform":
        return tree_stack([one(pat[0][0])] * cfg.n_layers)
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


def run_blocks(blocks, x, cfg, states=None, index=0, serve_window=0,
               active=None, tp=None):
    """Execute the block stack. Returns (x, states, aux), aux the fp32 sum
    of the blocks' aux losses (0 without MoE blocks); ``states`` (if
    given) are updated in place, layer by layer (with ``active``, only
    their rows it marks True). ``tp``: a ``models.parallel.TP`` whose
    rank runs its shard (``cfg`` the rank's config)."""
    windows = _serve_windows(cfg, serve_window)
    pat, n_cycles, rem = _cycles(cfg)
    total = None

    def add(aux):
        nonlocal total
        if aux is not None:
            total = aux if total is None else total + aux
    if _layout(cfg) == "uniform":
        for layer, window in enumerate(windows):
            st = None if states is None else tree_at(states, layer)
            x, _, aux = _apply_block(pat[0][0],
                                     tree_at(blocks["stack"], layer), x,
                                     cfg, window, st, index, active, tp)
            add(aux)
    else:
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
            x, _, aux = _apply_block(kind, p, x, cfg, window, st, index,
                                     active, tp)
            add(aux)
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, states, total


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


def _embed(params, cfg, tokens, prefix=None, tp=None):
    """Scaled token embeddings, with the prefix (B, P, D) before them.
    Under a ``TP`` the rank looks up its d_model columns, then the group
    gathers them."""
    x = params["embed"][tokens]
    if tp is not None:
        x = tp.all_gather(x)
    # made on the device: a host tensor copied over would synchronise
    x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                       device=x.device)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return x


def _head(params, cfg, x, tp=None):
    """fp32 logits of x (B, S, D). Under a ``TP``: the rank's vocabulary
    slice of ``lm_head``, gathered; tied embeddings give the rank's
    partial logits from its d_model columns, summed over the group."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if tp is None:
        logits = x @ (params["embed"].T if cfg.tie_embeddings
                      else params["lm_head"])
    elif cfg.tie_embeddings:
        part = x[..., tp.columns(x.shape[-1])] @ params["embed"].T
        logits = tp.all_reduce(part.to(torch.float32))
    else:
        logits = tp.all_gather((x @ params["lm_head"]).to(torch.float32))
    return softcap(logits.to(torch.float32), cfg.final_logit_softcap)


def lm_logits(cfg, params, tokens, prefix=None, tp=None):
    """Teacher-forced logits over the token positions only."""
    x = _embed(params, cfg, tokens, prefix, tp)
    x, _, aux = run_blocks(params["blocks"], x, cfg, tp=tp)
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    return _head(params, cfg, x, tp), aux


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
def lm_prefill(cfg, params, tokens, buf_len, prefix=None, serve_window=0,
               tp=None):
    """Run the prompt through the stack, filling fresh caches.
    Returns (last-token logits, states)."""
    x = _embed(params, cfg, tokens, prefix, tp)
    states = init_states(cfg, x.shape[0], buf_len, x.dtype, device=x.device)
    x, states, _ = run_blocks(params["blocks"], x, cfg, states=states,
                              index=0, serve_window=serve_window, tp=tp)
    return _head(params, cfg, x[:, -1:], tp)[:, 0], states


@torch.no_grad()
def lm_make_state(cfg, params, batch_size, buf_len, prefix=None,
                  serve_window=0, tp=None):
    """Blank decode states for ``batch_size`` sequences plus the stream
    start index (serving slot-reset / chunked-prefill entry point).
    Without a prefix the start is 0. A prefix (B, P, D) runs through the
    stack first, at positions ``0..P-1``, and the start is ``P``: the
    caller streams raw tokens only."""
    dtype = params["embed"].dtype
    states = init_states(cfg, batch_size, buf_len, dtype,
                         device=params["embed"].device)
    if prefix is None:
        return states, 0
    run_blocks(params["blocks"], prefix.to(dtype), cfg, states=states,
               index=0, serve_window=serve_window, tp=tp)
    return states, prefix.shape[1]


@torch.no_grad()
def lm_prefill_chunk(cfg, params, states, tokens, index, serve_window=0,
                     tp=None):
    """Run ``tokens`` (B, C) through the stack at absolute positions
    ``index..index+C-1``, updating the (possibly ring) caches in place.
    Returns (last-token logits (B, V), states): feeding a prompt chunk by
    chunk reproduces the one-shot ``lm_prefill``."""
    x = _embed(params, cfg, tokens, tp=tp)
    x, states, _ = run_blocks(params["blocks"], x, cfg, states=states,
                              index=int(index), serve_window=serve_window,
                              tp=tp)
    return _head(params, cfg, x[:, -1:], tp)[:, 0], states


@torch.no_grad()
def lm_decode_step(cfg, params, states, token, index, serve_window=0,
                   active=None, tp=None):
    """One decode step. token: (B, 1) int; index: the token's absolute
    position, a Python int for the whole batch, or a (B,) int tensor on
    the parameters' device, one a row (then ``states`` hold per-row
    (B, buf) ``pos`` tags, each row is its own MoE routing group, and
    the rows where the (B,) bool ``active`` is False keep every state).
    Returns (logits (B, V), states)."""
    x = _embed(params, cfg, token, tp=tp)
    x, states, _ = run_blocks(params["blocks"], x, cfg, states=states,
                              index=_step_index(index),
                              serve_window=serve_window, active=active,
                              tp=tp)
    return _head(params, cfg, x, tp)[:, 0], states
