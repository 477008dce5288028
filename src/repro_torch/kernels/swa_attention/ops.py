"""Attention in the model's (B, S, H, hd) layout over the swa_attention
kernel (counterpart of ``repro/kernels/swa_attention/ops.py``).

The serving prefill calls ``attention`` at index 0, where attention over a
blank position-tagged cache is exactly causal self-attention over the chunk
(``repro_torch.models.transformer._self_attention``). The transposes are
views: the kernel reads the model layout through its strides, and its
output, allocated with q's transposed strides, transposes back to a
contiguous (B, S, H, hd) tensor. Forward only: the kernel has no backward,
so the training path keeps ``models.attention.attend``.
"""
from __future__ import annotations

from repro_torch.kernels.swa_attention.swa_attention import swa_attention


def attention(q, k, v, *, causal=True, window=0, cap=0.0):
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd) -> (B, S, H, hd)."""
    o = swa_attention(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window,
                      cap=cap)
    return o.transpose(1, 2)
