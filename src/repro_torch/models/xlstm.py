"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent gate connections), arXiv:2405.04517 with the exponential-gating
stabiliser.

Counterpart of ``repro/models/xlstm.py``. d_ff = 0 in the config: each
block carries its own up / down projection (expand factor
``ssm_expand``).

Routes:

* sLSTM: with no gradient recorded (the serving lanes) the recurrence
  runs ``kernels.slstm_step.ops.slstm_scan``, the hand-written CUDA
  ``slstm_steps`` kernel on a card (its plain version on the CPU; with
  ``active`` the kernel's ``slstm_steps`` writes a fresh final state and
  only the active rows are copied back); when a
  gradient is recorded it runs the plain ``slstm_steps_ref`` loop, since
  the kernel has no backward (nor has the reference's). The reference's
  own ``slstm_forward`` runs its scan inline and never reaches its kernel
  (ROADMAP.md Queue 3); both compute the same recurrence.
* mLSTM: the per-step recurrence (``xlstm_chunk == 0``, or one token) and
  the chunkwise-parallel form (``_mlstm_chunked``) are plain torch, as
  the reference has no kernel for either.

A given state is updated in place (``run_blocks`` ignores returned
states), in the rows where ``active`` holds when it is given (the slot
engine's batched step); with no state a fresh one is made and
returned.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_step import ops as slstm_ops
from repro_torch.kernels.slstm_step.ref import slstm_steps_ref
from repro_torch.kernels.slstm_step.slstm_step import slstm_steps
from repro_torch.models.layers import (
    _randn, dense_init, records_grad, rms_norm, where_rows,
)

NEG_INF = -1e30


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or cfg.n_heads
    return d_in, H, d_in // H


def _write(state, new, active=None):
    """Copy ``new`` into the given state tuple in place (into the rows
    ``active`` marks True, when given); returns it."""
    for dst, src in zip(state, new):
        dst.copy_(where_rows(active, src, dst))
    return state


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen, cfg, dtype, *, device):
    d = cfg.d_model
    d_in, H, P = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "w_up": dense_init(gen, (d, 2 * d_in), dtype, device=device),
        "wq": dense_init(gen, (d_in, d_in), dtype, device=device),
        "wk": dense_init(gen, (d_in, d_in), dtype, device=device),
        "wv": dense_init(gen, (d_in, d_in), dtype, device=device),
        "w_i": dense_init(gen, (d_in, H), torch.float32, device=device),
        "b_i": torch.zeros((H,), **f32),
        "w_f": dense_init(gen, (d_in, H), torch.float32, device=device),
        "b_f": torch.full((H,), 3.0, **f32),   # forget-gate bias init
        "norm": torch.zeros((d_in,), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_in, d), dtype, device=device),
    }


def init_mlstm_state(cfg, batch, *, device):
    """(C (B, H, P, P), n (B, H, P), m (B, H)) fp32, m at -1e30."""
    _, H, P = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, P, P), **f32),
            torch.zeros((batch, H, P), **f32),
            torch.full((batch, H), NEG_INF, **f32))


def _mlstm_step(carry, q, k, v, i_raw, f_raw):
    """One token. carry: (C (B,H,P,P), n (B,H,P), m (B,H)); q, k, v:
    (B, H, P); i_raw, f_raw: (B, H). Returns (carry, h (B, H, P))."""
    C, n, m = carry
    m_new = torch.maximum(f_raw + m, i_raw)
    i = torch.exp(i_raw - m_new)
    f = torch.exp(f_raw + m - m_new)
    C = (f[..., None, None] * C
         + i[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = f[..., None] * n + i[..., None] * k
    num = torch.einsum("bhpq,bhp->bhq", C, q)
    den = torch.clamp(torch.abs(torch.einsum("bhp,bhp->bh", n, q)), min=1.0)
    return (C, n, m_new), num / den[..., None]


def _mlstm_steps(q, k, v, i_raw, f_raw, state):
    """The per-step recurrence over S tokens. q, k, v: (B, S, H, P);
    i_raw, f_raw: (B, S, H). Returns (h (B, S, H, P), state)."""
    hs = []
    for t in range(q.shape[1]):
        state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                               i_raw[:, t], f_raw[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), state


def _mlstm_chunked(q, k, v, i_raw, f_raw, state, chunk):
    """Chunkwise-parallel mLSTM: the exact stabilised equivalent of the
    per-step recurrence (the same log-gate algebra with the running max
    m), L = chunk tokens per loop step with dense (L, L) / (L, P)
    products. q, k, v: (B, S, H, P) fp32; i_raw, f_raw: (B, S, H).
    Returns (h (B, S, H, P), state)."""
    B, S, H, P = q.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        # padded steps: i = -inf (no write), f = 0 (identity decay)
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=NEG_INF)
        f_raw = F.pad(f_raw, (0, 0, 0, pad))
    nc = q.shape[1] // L
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
    C0, n0, m0 = state
    hs = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        qq, kk, vv, ii, ff = (a[:, sl] for a in (q, k, v, i_raw, f_raw))
        Fc = torch.cumsum(ff, dim=1)                       # (B, L, H)
        a = ii - Fc                                        # i_s - F_s
        m_intra = Fc + torch.cummax(a, dim=1).values       # (B, L, H)
        m_prev = m0[:, None] + Fc                          # (B, L, H)
        m = torch.maximum(m_intra, m_prev)
        # intra-chunk weights w[t, s] = exp(i_s + F_t - F_s - m_t)
        logw = a[:, None, :, :] + Fc[:, :, None, :] - m[:, :, None, :]
        logw = torch.where(causal[None, :, :, None], logw,
                           torch.full((), NEG_INF, device=q.device))
        w = torch.exp(logw)                                # (B, t, s, H)
        scores = torch.einsum("bthp,bshp->btsh", qq, kk)
        sw = scores * w
        num = torch.einsum("btsh,bshp->bthp", sw, vv)
        den = torch.sum(sw, dim=2)                         # (B, t, H)
        carry_scale = torch.exp(m_prev - m)                # (B, L, H)
        num = num + carry_scale[..., None] * torch.einsum(
            "bhpq,bthp->bthq", C0, qq)
        den = den + carry_scale * torch.einsum("bhp,bthp->bth", n0, qq)
        hs.append(num / torch.clamp(torch.abs(den), min=1.0)[..., None])

        # end-of-chunk state at the stabiliser m_L
        mL = m[:, -1]                                      # (B, H)
        FL = Fc[:, -1]                                     # (B, H)
        decay0 = torch.exp(m0 + FL - mL)                   # (B, H)
        sscale = torch.exp(ii + FL[:, None] - Fc - mL[:, None])  # (B, L, H)
        C0 = (decay0[:, :, None, None] * C0
              + torch.einsum("blh,blhp,blhq->bhpq", sscale, kk, vv))
        n0 = (decay0[:, :, None] * n0
              + torch.einsum("blh,blhp->bhp", sscale, kk))
        m0 = mL
    h = torch.cat(hs, dim=1)[:, :S]
    return h, (C0, n0, m0)


def mlstm_forward(p, x, cfg, state=None, active=None):
    """x: (B, S, D) -> (out, state). state: (C, n, m), updated in place
    (in the ``active`` rows) when given."""
    d_in, H, P = dims(cfg)
    B, S, _ = x.shape
    u = rms_norm(x, p["ln"], cfg.norm_eps)
    up = u @ p["w_up"]
    xi, z = up[..., :d_in], up[..., d_in:]
    q = (xi @ p["wq"]).reshape(B, S, H, P).to(torch.float32) * P ** -0.5
    k = (xi @ p["wk"]).reshape(B, S, H, P).to(torch.float32) * P ** -0.5
    v = (xi @ p["wv"]).reshape(B, S, H, P).to(torch.float32)
    xf = xi.to(torch.float32)
    i_raw = xf @ p["w_i"] + p["b_i"]                       # (B, S, H)
    f_raw = xf @ p["w_f"] + p["b_f"]

    given = state
    if state is None:
        state = init_mlstm_state(cfg, B, device=x.device)
    if cfg.xlstm_chunk and S > 1:
        h, new = _mlstm_chunked(q, k, v, i_raw, f_raw, state,
                                cfg.xlstm_chunk)
    else:
        h, new = _mlstm_steps(q, k, v, i_raw, f_raw, state)
    h = h.reshape(B, S, d_in).to(x.dtype)
    h = rms_norm(h * F.silu(z), p["norm"], cfg.norm_eps)
    out = h @ p["w_down"]
    return out, (new if given is None else _write(given, new, active))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg, dtype, *, device):
    d = cfg.d_model
    d_in, H, P = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "w_up": dense_init(gen, (d, 2 * d_in), dtype, device=device),
        "w_gates": dense_init(gen, (d_in, 4 * d_in), dtype,
                              device=device),             # z, i, f, o
        # block-diagonal recurrent weights
        "r_gates": _randn(gen, (H, P, 4 * P), device) * P ** -0.5,
        "b_gates": torch.cat([torch.zeros((2 * d_in,), **f32),
                              torch.full((d_in,), 3.0, **f32),
                              torch.zeros((d_in,), **f32)]),
        "norm": torch.zeros((d_in,), dtype=dtype, device=device),
        "w_down": dense_init(gen, (d_in, d), dtype, device=device),
    }


def init_slstm_state(cfg, batch, *, device):
    """(c, n, h, m) each (B, H, P) fp32: n at 1e-6 and m at -1e30, as the
    reference's fresh state."""
    _, H, P = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    shape = (batch, H, P)
    return (torch.zeros(shape, **f32), torch.full(shape, 1e-6, **f32),
            torch.zeros(shape, **f32), torch.full(shape, NEG_INF, **f32))


def slstm_forward(p, x, cfg, state=None, active=None):
    """x: (B, S, D) -> (out, state). state: (c, n, h, m) each (B, H, P),
    updated in place (in the ``active`` rows) when given."""
    d_in, H, P = dims(cfg)
    B, S, _ = x.shape
    u = rms_norm(x, p["ln"], cfg.norm_eps)
    up = u @ p["w_up"]
    xi, zgate = up[..., :d_in], up[..., d_in:]
    g_in = (xi.to(torch.float32) @ p["w_gates"].to(torch.float32)
            + p["b_gates"]).view(B, S, H, 4 * P)           # (B, S, H, 4P)

    given = state
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    if records_grad(g_in, p["r_gates"], *state):
        hs, new = slstm_steps_ref(g_in, p["r_gates"], state)
        state = new if given is None else _write(given, new, active)
    elif active is None:
        hs, state = slstm_ops.slstm_scan(g_in, p["r_gates"], state)
    else:
        hs, new = slstm_steps(g_in, p["r_gates"], state)
        state = _write(given, new, active)
    h = hs.reshape(B, S, d_in).to(x.dtype)
    h = rms_norm(h * F.silu(zgate), p["norm"], cfg.norm_eps)
    return h @ p["w_down"], state
