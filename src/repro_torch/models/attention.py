"""Attention primitives: GQA projections and chunked online-softmax
attention with sliding-window banding and logit softcap.

Counterpart of ``repro/models/attention.py``. ``attend`` is written with
plain torch ops, as the reference writes it in jnp (no fused attention
operator): one fp32 softmax when the keys fit one block (``_CHUNK`` keys
in training), else an online softmax over key blocks. The serving KV
cache is the reference's position-tagged buffer (full length or ring);
the port writes it in place. Attention over it takes larger blocks
(``serve_block``): serving keeps nothing for a backward pass, and every
block is a dozen more eager launches per layer.

Positions come in two forms. A Python int start gives one set of
positions for the whole batch, with one ``pos`` tag per buffer slot
(prefill, training, ``generate``). A (B,) tensor of starts gives each
row its own (the slot engine's batched decode step, as the reference's
vmap over slots): the rows' positions are (B, S), their caches carry
(B, buf) tags, and the mask is per row.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models.layers import dense_init, rope, softcap, where_rows

NEG_INF = -1e30
_CHUNK = 1024  # kv-block size for the online softmax
_SERVE_SCORES = 1 << 25  # fp32 scores per kv block over a serving cache


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

def positions(index, S, device):
    """Absolute positions of S tokens from their start: (S,) int32 from
    a Python int, (B, S) from a (B,) tensor of per-row starts."""
    ar = torch.arange(S, dtype=torch.int32, device=device)
    if torch.is_tensor(index):
        return index.to(torch.int32)[:, None] + ar
    return index + ar


def _mask(q_pos, kv_pos, causal, window):
    """Boolean validity broadcast into the (b, k, g, q, s) scores: shared
    positions q_pos (Sq,), kv_pos (Skv,) give a (1, 1, 1, Sq, Skv) mask,
    per-row ones (q_pos (B, Sq), kv_pos (B, Skv) or (Skv,)) a
    (B, 1, 1, Sq, Skv) one. kv_pos < 0 marks empty slots; ``window`` None
    or 0 disables banding."""
    q, kv = q_pos[..., :, None], kv_pos[..., None, :]
    m = kv >= 0
    if causal:
        m = m & (kv <= q)
    if window is not None:
        w = int(window) if int(window) > 0 else 2 ** 30
        m = m & (kv > q - w)
    return m[:, None, None] if m.dim() == 3 else m[None, None, None]


def serve_block(B, Sq, nq):
    """kv-block size for attention over a serving cache: the most keys
    (a multiple of ``_CHUNK``) whose (B, nq, Sq, block) fp32 scores stay
    within ``_SERVE_SCORES`` (128 MiB), and at least ``_CHUNK``. A decode
    step over an 8192-slot cache then takes one block."""
    return max(_CHUNK, _SERVE_SCORES // (B * nq * Sq) // _CHUNK * _CHUNK)


def attend(q, k, v, *, q_pos, kv_pos, causal=True, window=0, cap=0.0,
           block=_CHUNK):
    """GQA attention with online softmax over kv blocks of ``block`` keys.

    q: (B, Sq, nq, hd); k, v: (B, Skv, nkv, hd); q_pos (Sq,) or per row
    (B, Sq); kv_pos (Skv,) or per row (B, Skv). Returns (B, Sq, nq, hd).
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

    if Skv <= block:
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf)
        s = softcap(s, cap)
        s = torch.where(_mask(q_pos, kv_pos, causal, window), s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2).detach())
        l = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bkgqs,bskh->bkgqh", p, vf) / torch.clamp(l,
                                                                   min=1e-30)
        return finish(o)

    # chunked path: pad Skv to a multiple of block with invalid slots
    pad = (-Skv) % block
    if pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    n_chunks = kf.shape[1] // block

    def body(m, l, acc, kch, vch, pch):
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kch)
        s = softcap(s, cap)
        s = torch.where(_mask(q_pos, pch, causal, window), s, NEG_INF)
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
        sl = slice(c * block, (c + 1) * block)
        # rematerialized in the backward pass, as the reference's
        # jax.checkpoint'ed scan body
        m, l, acc = torch.utils.checkpoint.checkpoint(
            body, m, l, acc, kf[:, sl], vf[:, sl], kv_pos[..., sl],
            use_reentrant=False)
    return finish(acc / torch.clamp(l, min=1e-30)[..., None])


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(batch, n_kv, buf_len, head_dim, dtype, *, device):
    """Position-tagged cache. ``pos`` = -1 marks empty slots; a windowed
    buffer (buf_len == window) becomes a ring buffer transparently."""
    return {
        "k": torch.zeros((batch, buf_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, buf_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((buf_len,), -1, dtype=torch.int32, device=device),
    }


def cache_update(cache, k_new, v_new, index, active=None):
    """Write k/v for ``k_new.shape[1]`` tokens starting at absolute position
    ``index`` into the (possibly ring) buffer, IN PLACE (the reference
    returns a new cache; the port saves the copy). Returns ``cache``.

    Invariant: position ``p`` always lives in slot ``p % buf``, so a chunk
    write that crosses the ring seam wraps, and a later decode step
    overwrites exactly the slot whose position expired.

    ``index`` a (B,) tensor: one token a row, row b's at position
    ``index[b]`` into slot ``index[b] % buf`` of its own row of a cache
    whose ``pos`` is (B, buf). Rows where the (B,) bool ``active`` is
    False keep what they held: each row's old entry is gathered and
    written back in place of the new one, so the write touches one slot a
    row and reads nothing back to the host."""
    if torch.is_tensor(index):
        return _cache_update_rows(cache, k_new, v_new, index, active)
    buf = cache["k"].shape[1]
    S = k_new.shape[1]
    if S > buf:
        raise ValueError(
            f"cache_update: {S}-token write exceeds buf_len {buf} — stream "
            f"the prompt in chunks of at most buf_len")
    pos = index + torch.arange(S, dtype=torch.int32, device=k_new.device)
    slots = (pos % buf).long()
    cache["k"][:, slots] = k_new.to(cache["k"].dtype)
    cache["v"][:, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][slots] = pos
    return cache


def _cache_update_rows(cache, k_new, v_new, index, active):
    B, S = k_new.shape[:2]
    if S != 1:
        raise ValueError(f"cache_update: a per-row index writes one token a "
                         f"row, got {S}")
    rows = torch.arange(B, device=k_new.device)
    pos = index.to(torch.int32)
    slots = (pos % cache["k"].shape[1]).long()
    k1 = where_rows(active, k_new[:, 0].to(cache["k"].dtype),
                    cache["k"][rows, slots])
    v1 = where_rows(active, v_new[:, 0].to(cache["v"].dtype),
                    cache["v"][rows, slots])
    pos = where_rows(active, pos, cache["pos"][rows, slots])
    cache["k"][rows, slots] = k1
    cache["v"][rows, slots] = v1
    cache["pos"][rows, slots] = pos
    return cache


__all__ = ["attend", "cache_update", "init_attention", "init_cache",
           "out_proj", "positions", "qkv_proj", "rope", "serve_block"]
