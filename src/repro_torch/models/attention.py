"""Attention primitives: GQA projections and chunked online-softmax
attention with sliding-window banding and logit softcap.

Counterpart of ``repro/models/attention.py``. ``attend`` is written with
plain torch ops, as the reference writes it in jnp (no fused attention
operator): one fp32 softmax when the keys fit one ``_CHUNK``, else an
online softmax over ``_CHUNK``-sized key blocks. The KV cache belongs to
serving and is not ported yet.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models.layers import dense_init, rope, softcap

NEG_INF = -1e30
_CHUNK = 1024  # kv-block size for the online softmax


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def init_attention(gen, d_model, n_heads, n_kv_heads, head_dim, dtype,
                   qkv_bias=False, *, device):
    p = {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), dtype,
                         device=device),
        "wk": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype,
                         device=device),
        "wv": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype,
                         device=device),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), dtype,
                         fan_in=n_heads * head_dim, device=device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype,
                              device=device)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=device)
    return p


def qkv_proj(p, x, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv_heads, head_dim),
            v.reshape(B, S, n_kv_heads, head_dim))


def out_proj(p, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# Core attention
# ---------------------------------------------------------------------------

def _mask(q_pos, kv_pos, causal, window):
    """(Sq, Skv) boolean validity. kv_pos < 0 marks empty slots; ``window``
    None or 0 disables banding."""
    m = kv_pos[None, :] >= 0
    if causal:
        m = m & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        w = int(window) if int(window) > 0 else 2 ** 30
        m = m & (kv_pos[None, :] > q_pos[:, None] - w)
    return m


def attend(q, k, v, *, q_pos, kv_pos, causal=True, window=0, cap=0.0):
    """GQA attention with online softmax over kv chunks.

    q: (B, Sq, nq, hd); k, v: (B, Skv, nkv, hd); q_pos (Sq,), kv_pos (Skv,).
    Returns (B, Sq, nq, hd).
    """
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, nkv, g, hd).to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    def finish(o):
        return o.reshape(B, nkv * g, Sq, hd).permute(0, 2, 1, 3).to(q.dtype)

    if Skv <= _CHUNK:
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf)
        s = softcap(s, cap)
        s = torch.where(_mask(q_pos, kv_pos, causal, window)[None, None, None],
                        s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2).detach())
        l = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bkgqs,bskh->bkgqh", p, vf) / torch.clamp(l,
                                                                   min=1e-30)
        return finish(o)

    # chunked path: pad Skv to a multiple of _CHUNK with invalid slots
    pad = (-Skv) % _CHUNK
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    n_chunks = kf.shape[1] // _CHUNK

    def body(m, l, acc, kch, vch, pch):
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kch)
        s = softcap(s, cap)
        s = torch.where(_mask(q_pos, pch, causal, window)[None, None, None],
                        s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # a fully-masked chunk keeps m_new at NEG_INF; clamp so
        # exp(NEG_INF - NEG_INF) does not turn masked scores into 1.0
        p = torch.exp(s - torch.clamp(m_new, min=NEG_INF / 2)[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p,
                                                   vch)
        return m_new, l, acc

    m = torch.full((B, nkv, g, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, nkv, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nkv, g, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        sl = slice(c * _CHUNK, (c + 1) * _CHUNK)
        # rematerialized in the backward pass, as the reference's
        # jax.checkpoint'ed scan body
        m, l, acc = torch.utils.checkpoint.checkpoint(
            body, m, l, acc, kf[:, sl], vf[:, sl], kv_pos[sl],
            use_reentrant=False)
    return finish(acc / torch.clamp(l, min=1e-30)[..., None])


__all__ = ["attend", "init_attention", "out_proj", "qkv_proj", "rope"]
