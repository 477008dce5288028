"""Plain PyTorch version of the sliding-window attention kernel.

Counterpart of ``repro/kernels/swa_attention/ref.py``: layout
(B, H, S, hd), fp32 math, causal mask, window banding, GQA head grouping
(query head h reads kv head h // (H // Hkv)) and an optional tanh logit
softcap. The CPU tests hold it against the reference's ``swa_attention_ref``
and ``chip_smoke.py`` holds the CUDA kernel against it on the card; the
model path on a card never calls it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def swa_attention_plain(q, k, v, *, causal=True, window=0, cap=0.0):
    """q: (B, H, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, H, Sq, hd).

    The (B, Hkv, g, Sq, Skv) fp32 score tensor is transformed in place, so
    the peak is about twice its size (one batch row of the serving shape
    S = 8160, H = 8 is 2.1 GB)."""
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = (q.to(torch.float32) * hd ** -0.5).reshape(B, Hkv, g, Sq, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.to(torch.float32))
    if cap:
        s.div_(cap).tanh_().mul_(cap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s.masked_fill_(~mask, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = s.sub_(torch.clamp(m, min=NEG_INF / 2)).exp_()
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.to(torch.float32))
    o = o / torch.clamp(l, min=1e-30)
    return o.reshape(B, H, Sq, hd).to(q.dtype)
