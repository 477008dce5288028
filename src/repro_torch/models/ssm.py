"""Mamba2 (SSD) block — chunked selective-state-space scan.

Counterpart of ``repro/models/ssm.py``. Per head h, scalar decay
a_t = exp(-exp(A_log_h) * dt_t):
    H_t = a_t * H_{t-1} + (dt_t * x_t) outer B_t          (H: (P, N))
    y_t = H_t @ C_t + D_h * x_t
Training and prefill use the chunked SSD formulation (intra-chunk dense
products + an inter-chunk scan over states); decode carries the (ssm,
conv) state.

Routes of the chunked branch: with no gradient recorded (the serving
lanes) it runs ``kernels.mamba_scan.ops.ssd_scan``, whose intra-chunk part
is the hand-written CUDA ``ssd_chunks`` kernel on a card (its plain
version on the CPU); when a gradient is recorded it runs the plain
``_ssd_chunked`` below, since the kernel has no backward (nor has the
reference's). The decode branch (one token with a state) stays plain
torch. A given state is updated in place; with ``active`` (the slot
engine's batched step) only in the rows it marks True.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as ssd_ops
from repro_torch.kernels.mamba_scan.ref import ssd_chunks_seq_plain
from repro_torch.models.layers import (
    _randn, dense_init, records_grad, rms_norm, where_rows,
)


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or d_in // 64
    head_p = d_in // heads
    return d_in, heads, head_p


def init_mamba(gen, cfg, dtype, *, device):
    d = cfg.d_model
    d_in, H, P = dims(cfg)
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": torch.zeros((d,), dtype=dtype, device=device),
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * N + H), dtype,
                              device=device),
        "conv_w": (_randn(gen, (cfg.ssm_conv, conv_dim), device)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 8.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.zeros((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (d_in, d), dtype, device=device),
    }


def _split(p, u, cfg):
    """in_proj -> z (gate), xBC (conv stream), dt."""
    d_in, H, _ = dims(cfg)
    N = cfg.ssm_state
    zxbcdt = u @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, conv_state=None):
    """Depthwise causal conv over time. xBC: (B, S, Cd); w: (K, Cd).
    Returns (silu(conv), the last K - 1 inputs as the new conv state)."""
    K, S = w.shape[0], xBC.shape[1]
    if conv_state is None:
        pad = xBC.new_zeros(xBC.shape[:1] + (K - 1,) + xBC.shape[2:])
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                   # (B, S+K-1, Cd)
    out = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):] if K > 1 else pad[:, :0]
    return F.silu(out), new_state


def _ssd_chunked(xh, B_, C_, a_log, chunk, h0=None):
    """Chunked SSD scan, plain torch (the training route): the one scan of
    ``kernels/mamba_scan/ops.py`` over the plain intra-chunk products,
    which autograd differentiates.

    xh: (Bt, S, H, P) inputs already scaled by dt; B_, C_: (Bt, S, N);
    a_log: (Bt, S, H) per-step log decay (<= 0). ``h0`` (Bt, H, P, N) is
    the carried-in state for streamed (chunked) prefill. Returns y:
    (Bt, S, H, P) and final state (Bt, H, P, N).
    """
    return ssd_ops.chunked_scan(ssd_chunks_seq_plain, xh, B_, C_, a_log,
                                chunk, h0)


def mamba_forward(p, x, cfg, state=None, active=None):
    """x: (B, S, D). state: None (train / prefill from scratch) or
    {"ssm": (B,H,P,N), "conv": (B,K-1,Cd)}, updated in place, in the rows
    where the (B,) bool ``active`` holds when it is given.
    Returns (out (B,S,D), new_state)."""
    d_in, H, P = dims(cfg)
    N = cfg.ssm_state
    u = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xBC, dt_raw = _split(p, u, cfg)
    conv_in = None if state is None else state["conv"]
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_in)
    xs = xBC[..., :d_in]
    B_ = xBC[..., d_in:d_in + N].to(torch.float32)
    C_ = xBC[..., d_in + N:].to(torch.float32)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # (B,S,H)
    a_log = -torch.exp(p["A_log"]) * dt                         # (B,S,H)

    Bt, S, _ = x.shape
    xh = xs.reshape(Bt, S, H, P).to(torch.float32)
    xh_dt = xh * dt[..., None]

    if S == 1 and state is not None:
        h_prev = state["ssm"]
        a = torch.exp(a_log[:, 0])                              # (B, H)
        h_new = (a[:, :, None, None] * h_prev
                 + torch.einsum("bhp,bn->bhpn", xh_dt[:, 0], B_[:, 0]))
        y = torch.einsum("bhpn,bn->bhp", h_new, C_[:, 0])[:, None]
        ssm_state = h_new
    else:
        h0 = None if state is None else state["ssm"]
        scan = (_ssd_chunked if records_grad(xh_dt, B_, C_, a_log)
                else ssd_ops.ssd_scan)
        y, ssm_state = scan(xh_dt, B_, C_, a_log, cfg.ssm_chunk, h0=h0)

    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(Bt, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if state is None:
        return out, {"ssm": ssm_state, "conv": conv_state}
    state["ssm"].copy_(where_rows(active, ssm_state, state["ssm"]))
    state["conv"].copy_(where_rows(active, conv_state, state["conv"]))
    return out, state


def init_mamba_state(cfg, batch, dtype, *, device):
    d_in, H, P = dims(cfg)
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
