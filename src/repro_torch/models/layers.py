"""Shared primitive layers: norms, RoPE, gated MLPs, inits, softcap.

Counterpart of ``repro/models/layers.py``. Inits draw from an explicit
``torch.Generator`` on ``device``; on the ``meta`` device they allocate
nothing and draw nothing (``params_from_numpy`` reads the expected shapes
that way).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _randn(gen, shape, device):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, shape, dtype, fan_in=None, *, device):
    """Variance-scaling normal init (fan-in)."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 \
        else shape[-1]
    return (_randn(gen, shape, device) * fan_in ** -0.5).to(dtype)


def embed_init(gen, shape, dtype, *, device):
    return (_randn(gen, shape, device) * 0.02).to(dtype)


def where_rows(active, new, old):
    """``new`` in the rows (leading axis) where the (B,) bool ``active``
    holds, ``old`` in the others; ``new`` itself when ``active`` is None.
    The slot engine's batched decode step freezes its inactive rows so."""
    if active is None:
        return new
    return torch.where(active.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def records_grad(*ts):
    """Whether autograd records a graph through any of ``ts``: the model's
    kernels have no backward, so their callers take a plain route then."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# Norms, softcap, RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps=1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope(x, positions, theta: float):
    """Apply rotary embeddings. x: (..., S, H, hd); positions (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.tensor(math.log(theta), dtype=torch.float32)
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, half)
    ang = ang[..., None, :]                     # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def init_mlp(gen, d_model, d_ff, dtype, *, device):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device=device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device=device),
    }


def mlp(p, x, act: str, tp=None):
    """The gated MLP. Under a ``models.parallel.TP`` its ``w_gate`` /
    ``w_up`` are the rank's output columns and ``w_down`` its input rows:
    the rank's partial sum, then one all-reduce."""
    g = act_fn(act)(x @ p["w_gate"])
    out = (g * (x @ p["w_up"])) @ p["w_down"]
    return out if tp is None else tp.all_reduce(out)
