"""Encoder-decoder backbone (seamless-m4t): an encoder over stubbed frame
embeddings, a decoder with self- and cross-attention (counterpart of
``repro/models/encdec.py``).

The parameter tree is the reference's: ``{"embed", "enc": attention +
MLP blocks stacked over the encoder layers, "enc_norm", "dec": decoder
blocks {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"} stacked over the
decoder layers, "final_norm", "lm_head"}``. The layers run as a Python
loop where the reference scans.

The encoder attends over every frame (not causal), with rope on frame
positions. A decoder block's cross-attention takes q from ``xattn/wq``
alone (no rope, no bias) and k, v from the encoder output. Serving states
are ``{"self": stacked KV caches, "ck", "cv": (L, B, F, nkv, hd)}``: the
cross k / v are computed once, in ``encdec_make_state``, and ride in the
state, so a serving slot carries its request's frames.

Serving runs forward only, and there the hand-written ``swa_attention``
kernel (``kernels/swa_attention``) takes the encoder pass (non-causal,
frames x frames), the decoder's self-attention at index 0 (causal over a
blank cache, as ``models/transformer.py`` does) and the cross-attention of
every prefill chunk (non-causal, chunk x frames). Decode steps and the
training loss keep ``attend``, as the reference does in jnp (the kernel
has no backward). A decode step's ``index`` takes the two forms of
``transformer.lm_decode_step``: per-row positions (the slot engine) come
with per-row ``pos`` tags and the ``active`` rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import tree_at, tree_stack
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import embed_init, init_mlp, mlp, rms_norm
from repro_torch.models.transformer import (
    _blank_start, _embed, _head, _step_index, cross_entropy, init_attn_block,
    stack_init,
)


def _init_dec_block(gen, cfg, dtype, *, device):
    d = cfg.d_model

    def norm():
        return torch.zeros((d,), dtype=dtype, device=device)

    def attention():
        return attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, dtype, cfg.qkv_bias,
                                   device=device)
    # a dict display evaluates in order: the leaves draw from gen in turn
    return {"ln1": norm(), "attn": attention(), "lnx": norm(),
            "xattn": attention(), "ln2": norm(),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype, device=device)}


def init_encdec(cfg, gen, *, device):
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.vocab_size, d), dtype, device=device),
        "enc": stack_init(lambda: init_attn_block(gen, cfg, dtype,
                                                  device=device),
                          cfg.n_enc_layers),
        "enc_norm": torch.zeros((d,), dtype=dtype, device=device),
        "dec": stack_init(lambda: _init_dec_block(gen, cfg, dtype,
                                                  device=device),
                          cfg.n_layers),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
        "lm_head": embed_init(gen, (d, cfg.vocab_size), dtype,
                              device=device),
    }


def encode(cfg, params, enc_in, kernel=False):
    """enc_in: stubbed frame embeddings (B, F, D) from the audio
    frontend, on the parameters' device. ``kernel``: attention through
    ``swa_attention`` (serving, forward only) instead of ``attend``."""
    x = enc_in.to(params["embed"].dtype)
    F = x.shape[1]
    pos = torch.arange(F, dtype=torch.int32, device=x.device)
    for layer in range(cfg.n_enc_layers):
        p = tree_at(params["enc"], layer)
        u = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_proj(p["attn"], u, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim)
        q = attn.rope(q, pos, cfg.rope_theta)
        k = attn.rope(k, pos, cfg.rope_theta)
        if kernel:
            o = swa_ops.attention(q, k, v, causal=False)
        else:
            o = attn.attend(q, k, v, q_pos=pos, kv_pos=pos, causal=False)
        x = x + attn.out_proj(p["attn"], o)
        x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(p, x, cfg, cross_k, cross_v, cache, index, window=0,
               kernel=False, active=None):
    """One decoder block; with a cache, ``index`` is the chunk's first
    absolute position (a Python int, or a (B,) tensor of per-row ones)
    and the cache is written in place (in the ``active`` rows).
    ``kernel``: a serving prefill lane (the kernel at index 0 and for the
    cross-attention)."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_proj(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim)
    pos = attn.positions(index, S, x.device)
    q = attn.rope(q, pos, cfg.rope_theta)
    k = attn.rope(k, pos, cfg.rope_theta)
    if cache is None:
        o = attn.attend(q, k, v, q_pos=pos, kv_pos=pos, causal=True)
    else:
        attn.cache_update(cache, k, v, index, active)
        if kernel and _blank_start(index):
            # blank cache: attention over it is causal self-attention
            o = swa_ops.attention(q, k, v, causal=True, window=window or 0)
        else:
            o = attn.attend(q, cache["k"], cache["v"], q_pos=pos,
                            kv_pos=cache["pos"], causal=True, window=window,
                            block=attn.serve_block(*q.shape[:3]))
    x = x + attn.out_proj(p["attn"], o)

    hx = rms_norm(x, p["lnx"], cfg.norm_eps)
    qx = (hx @ p["xattn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if kernel:
        ox = swa_ops.attention(qx, cross_k, cross_v, causal=False)
    else:
        fpos = torch.arange(cross_k.shape[1], dtype=torch.int32,
                            device=x.device)
        ox = attn.attend(qx, cross_k, cross_v, q_pos=pos, kv_pos=fpos,
                         causal=False)
    x = x + attn.out_proj(p["xattn"], ox)

    return x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg.act)


def _cross_kv(p, enc_out, cfg):
    B, F, _ = enc_out.shape
    k = (enc_out @ p["xattn"]["wk"]).reshape(B, F, cfg.n_kv_heads,
                                             cfg.head_dim)
    v = (enc_out @ p["xattn"]["wv"]).reshape(B, F, cfg.n_kv_heads,
                                             cfg.head_dim)
    return k, v


def decode_stack(cfg, params, x, enc_out=None, states=None, index=0,
                 window=0, kernel=False, active=None):
    """Run the decoder stack. ``states``: None (training: cross k / v from
    ``enc_out``) or ``{"self", "ck", "cv"}``, updated in place. ``window``
    bands the cached self-attention (serving ring buffer);
    cross-attention always sees every encoder frame."""
    for layer in range(cfg.n_layers):
        p = tree_at(params["dec"], layer)
        if states is None:
            ck, cv = _cross_kv(p, enc_out, cfg)
            x = _dec_block(p, x, cfg, ck, cv, None, 0)
        else:
            x = _dec_block(p, x, cfg, states["ck"][layer],
                           states["cv"][layer],
                           tree_at(states["self"], layer), index,
                           window=window, kernel=kernel, active=active)
    return x, states


def encdec_loss(cfg, params, batch):
    enc_out = encode(cfg, params, batch["enc"])
    x = _embed(params, cfg, batch["tokens"])
    x, _ = decode_stack(cfg, params, x, enc_out=enc_out)
    loss = cross_entropy(_head(params, cfg, x), batch["labels"])
    return loss, {"loss": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


def init_states(cfg, batch, buf_len, frames, dtype, *, device):
    """Blank serving states: fresh self-attention caches and unfilled
    (L, batch, frames, nkv, hd) cross k / v."""
    one = attn.init_cache(batch, cfg.n_kv_heads, buf_len, cfg.head_dim,
                          dtype, device=device)
    cross = (cfg.n_layers, batch, frames, cfg.n_kv_heads, cfg.head_dim)
    return {"self": tree_stack([one] * cfg.n_layers),
            "ck": torch.empty(cross, dtype=dtype, device=device),
            "cv": torch.empty(cross, dtype=dtype, device=device)}


@torch.no_grad()
def encdec_make_state(cfg, params, batch_size, buf_len, enc=None,
                      serve_window=0):
    """Blank decoder states primed with the request's encoder pass: the
    cross k / v are computed once here and ride in the state. Returns
    (states, start index 0)."""
    del serve_window
    enc_out = encode(cfg, params, enc, kernel=True)
    states = init_states(cfg, batch_size, buf_len, enc_out.shape[1],
                         enc_out.dtype, device=enc_out.device)
    for layer in range(cfg.n_layers):
        k, v = _cross_kv(tree_at(params["dec"], layer), enc_out, cfg)
        states["ck"][layer] = k
        states["cv"][layer] = v
    return states, 0


@torch.no_grad()
def encdec_prefill_chunk(cfg, params, states, tokens, index, serve_window=0):
    """One stream chunk of decoder prefill (see ``lm_prefill_chunk``)."""
    x = _embed(params, cfg, tokens)
    x, states = decode_stack(cfg, params, x, states=states, index=int(index),
                             window=serve_window, kernel=True)
    return _head(params, cfg, x[:, -1:])[:, 0], states


@torch.no_grad()
def encdec_prefill(cfg, params, tokens, buf_len, enc=None, serve_window=0):
    states, _ = encdec_make_state(cfg, params, tokens.shape[0], buf_len,
                                  enc=enc)
    return encdec_prefill_chunk(cfg, params, states, tokens, 0,
                                serve_window)


@torch.no_grad()
def encdec_decode_step(cfg, params, states, token, index, serve_window=0,
                       active=None):
    """One decode step (``index`` and ``active`` as in
    ``transformer.lm_decode_step``). Returns (logits (B, V), states)."""
    x = _embed(params, cfg, token)
    x, states = decode_stack(cfg, params, x, states=states,
                             index=_step_index(index), window=serve_window,
                             active=active)
    return _head(params, cfg, x)[:, 0], states
