"""Plain PyTorch versions of the DPPF consensus kernels.

The same arithmetic as the CUDA kernels in ``csrc/pullpush.cu``, written
with torch ops. The wrappers in ``pullpush.py`` take these for tensors that
lie on the CPU (the CPU tests); on the card they are what ``chip_smoke.py``
holds each kernel against. They mirror the phases of the reference
``repro/kernels/pullpush/pullpush.py::fused_round``:

* ``partial_gram_plain`` — block-centered Gram: every column is shifted by
  its row-0 value (``e = x - x[0]``), so entries are O(spread^2) and every
  zero-sum quadratic form of G is free of cancellation;
* ``gram_coef_plain`` — ``r_i = ||x_i - T_i x||`` from the zero-sum form
  ``(e_i - T_i)^T G (e_i - T_i)`` and ``coef = c0 + c1 / max(r, eps)``;
* ``mix_shard_plain`` — the uniform gap form ``tx + (1 - c)(x - tx)``,
  exact at c = 1 and for huge |c|.

Each works on column chunks of ``PLAIN_CHUNK`` columns so that its
temporaries stay bounded at the main path's width (R x 1.2e9 fp32); a
chunk boundary only re-anchors the centering, which cancels in every
zero-sum form.
"""
from __future__ import annotations

import torch

PLAIN_CHUNK = 1 << 22


def partial_gram_plain(flat):
    """(R, n) fp32 -> (R, R) block-centered Gram (zero-sum forms only)."""
    R, n = flat.shape
    G = torch.zeros((R, R), dtype=torch.float32, device=flat.device)
    for a in range(0, n, PLAIN_CHUNK):
        x = flat[:, a:a + PLAIN_CHUNK]
        e = x - x[0:1]
        G += e @ e.T
    return G


def gram_coef_plain(G, T, c0, c1, eps=1e-12):
    """Per-row distance to the target and mixing coefficient from a
    (block-centered) Gram. ``T`` row-stochastic; c0, c1 (R,). Returns
    ``(r, coef)``."""
    tg = T @ G
    diag_g = torch.diagonal(G)
    diag_tg = torch.sum(T * G, dim=1)            # G symmetric
    diag_tgt = torch.sum(tg * T, dim=1)
    r2 = diag_g - 2.0 * diag_tg + diag_tgt
    r = torch.sqrt(torch.clamp(r2, min=0.0))
    return r, c0 + c1 / torch.clamp(r, min=eps)


def mix_shard_plain(flat, T, coef, out=None):
    """``out_i = T_i x + (1 - coef_i)(x_i - T_i x)`` per column. ``out``
    may be ``flat`` itself: each chunk is read in full before it is
    written."""
    R, n = flat.shape
    if out is None:
        out = torch.empty_like(flat)
    oc = (1.0 - coef)[:, None]
    for a in range(0, n, PLAIN_CHUNK):
        x = flat[:, a:a + PLAIN_CHUNK]
        tx = T @ x
        out[:, a:a + PLAIN_CHUNK] = tx + oc * (x - tx)
    return out


def fused_round_plain(flat, T, c0, c1, eps=1e-12, out=None):
    """One consensus stage: returns ``(out, r, G)`` like ``fused_round``."""
    G = partial_gram_plain(flat)
    r, coef = gram_coef_plain(G, T, c0, c1, eps)
    return mix_shard_plain(flat, T, coef, out=out), r, G
