"""Plain PyTorch versions of the DPPF consensus kernels.

The same arithmetic as the CUDA kernels in ``csrc/pullpush.cu``, written
with torch ops. The wrappers in ``pullpush.py`` take these for tensors that
lie on the CPU (the CPU tests); on the card they are what ``chip_smoke.py``
holds each kernel against. They mirror the phases of the reference
``repro/kernels/pullpush/pullpush.py::fused_round``:

* ``partial_gram_plain`` — block-centered Gram: every column is shifted by
  its row-0 value (``e = x - x[0]``), so entries are O(spread^2) and every
  zero-sum quadratic form of G is free of cancellation;
* ``gram_sum_plain`` — the kernels' fixed-order sum of a stack of block
  partials into G (``gram_coef_kernel``, the partial-Gram tail), every
  addition rounded on its own: the kernel's bits;
* ``gram_coef_plain`` — ``r_i = ||x_i - T_i x||`` from the zero-sum form
  ``(e_i - T_i)^T G (e_i - T_i)`` and ``coef = c0 + c1 / max(r, eps)``;
* ``mix_shard_plain`` — the uniform gap form ``tx + (1 - c)(x - tx)``,
  exact at c = 1 and for huge |c|; ``tx = T x`` summed over the rows in
  order, every product and sum rounded on its own, as the kernel does, so
  the two agree bit for bit on the card;
* ``stale_mix_plain`` — the overlap modes' stale epilogue ``q + (mix(s)
  - s)`` (``src/repro/train/trainer.py:387``), in the same rounding;
* ``mix_from_gram_plain`` — a stage from a given Gram
  (``pullpush.py::mix_from_gram``): ``gram_coef_plain``, then the mix or
  the stale epilogue;
* ``fused_round_leaves_plain`` — the stage on a worker-stacked tree's
  leaves (``pullpush.py::fused_round_leaves``): the leaves flattened into
  one fp32 (M, n) view, ``fused_round_plain``, each leaf's columns cast
  back to its dtype;
* ``fused_round_sharded_plain`` — a stage on one column shard
  (``pullpush.py::fused_round_sharded``): ``partial_gram_plain``, the
  Gram completed over the column group by ``reduce``, then
  ``mix_from_gram_plain``.

and the tree path's pair, twins of the reference's ``ref.py::sq_dist_ref``
and ``apply_ref``:

* ``sq_dist_plain`` — ``Σ (x − a)²`` in fp32;
* ``apply_plain`` — ``x + (a − x)·coef`` in fp32, three rounded
  operations as the kernel does them, cast to x's dtype.

The Gram and mix functions work on column chunks of ``PLAIN_CHUNK``
columns so that their temporaries stay bounded at the main path's width (R x 1.2e9 fp32); a
chunk boundary only re-anchors the centering, which cancels in every
zero-sum form.
"""
from __future__ import annotations

import torch

PLAIN_CHUNK = 1 << 22
COEF_THREADS = 1024    # kCoefThreads: the fixed-order sum's slots


def partial_gram_plain(flat):
    """(R, n) fp32 -> (R, R) block-centered Gram (zero-sum forms only)."""
    R, n = flat.shape
    G = torch.zeros((R, R), dtype=torch.float32, device=flat.device)
    for a in range(0, n, PLAIN_CHUNK):
        x = flat[:, a:a + PLAIN_CHUNK]
        e = x - x[0:1]
        G += e @ e.T
    return G


def gram_sum_plain(ws):
    """(nblk, R, R) block partials -> (R, R) G in the kernels' order: C =
    COEF_THREADS // R^2 chunks (at least one); chunk ch adds the blocks
    ch, ch + C, ... in turn, then the C chunk sums are added in chunk
    order. Each fp32 addition is rounded on its own, as on the card."""
    nblk, R, _ = ws.shape
    RR = R * R
    C = max(COEF_THREADS // RR, 1)
    steps = -(-nblk // C)
    # padded with zeros: 0 + s = s for every sum that starts at +0
    pad = torch.zeros((steps * C, RR), dtype=torch.float32, device=ws.device)
    pad[:nblk] = ws.reshape(nblk, RR)
    part = torch.zeros((C, RR), dtype=torch.float32, device=ws.device)
    for k in range(steps):
        part = part + pad[k * C:(k + 1) * C]
    G = torch.zeros((RR,), dtype=torch.float32, device=ws.device)
    for ch in range(C):
        G = G + part[ch]
    return G.reshape(R, R)


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


def _mix_chunk(x, T, oc):
    """``tx + oc (x - tx)`` with ``tx = sum_j T[:, j] x_j`` in j order,
    one rounding per operation (the kernel's ``__fmul_rn``/``__fadd_rn``)."""
    tx = torch.zeros_like(x)
    for j in range(x.shape[0]):
        tx = tx + T[:, j:j + 1] * x[j:j + 1]
    return tx + oc * (x - tx)


def mix_shard_plain(flat, T, coef, out=None):
    """``out_i = T_i x + (1 - coef_i)(x_i - T_i x)`` per column. ``out``
    may be ``flat`` itself: each chunk is read in full before it is
    written."""
    R, n = flat.shape
    if out is None:
        out = torch.empty_like(flat)
    oc = (1.0 - coef)[:, None]
    for a in range(0, n, PLAIN_CHUNK):
        out[:, a:a + PLAIN_CHUNK] = _mix_chunk(flat[:, a:a + PLAIN_CHUNK],
                                               T, oc)
    return out


def stale_mix_plain(flat, T, coef, base, out=None):
    """``out = base + (mix_shard_plain(flat) - flat)``, chunk by chunk;
    ``out`` may be ``flat`` or ``base``."""
    R, n = flat.shape
    if out is None:
        out = torch.empty_like(flat)
    oc = (1.0 - coef)[:, None]
    for a in range(0, n, PLAIN_CHUNK):
        x = flat[:, a:a + PLAIN_CHUNK]
        m = _mix_chunk(x, T, oc)
        out[:, a:a + PLAIN_CHUNK] = base[:, a:a + PLAIN_CHUNK] + (m - x)
    return out


def mix_from_gram_plain(flat, T, c0, c1, G, eps=1e-12, out=None, base=None):
    """A stage from a given Gram: returns ``(out, r, G)``; with ``base``
    the output is the stale epilogue's."""
    r, coef = gram_coef_plain(G, T, c0, c1, eps)
    if base is None:
        return mix_shard_plain(flat, T, coef, out=out), r, G
    return stale_mix_plain(flat, T, coef, base, out=out), r, G


def fused_round_sharded_plain(flat, T, c0, c1, reduce, eps=1e-12, out=None,
                              base=None):
    """One consensus stage on a (R, n_local) column shard: the partial
    Gram, ``reduce(G)`` (the sum over the column group, in place), then
    the coefficients and the mix (the stale epilogue with ``base``).
    Returns ``(out, r, G)`` with the completed Gram."""
    G = reduce(partial_gram_plain(flat))
    return mix_from_gram_plain(flat, T, c0, c1, G, eps, out=out, base=base)


def fused_round_plain(flat, T, c0, c1, eps=1e-12, out=None):
    """One consensus stage: returns ``(out, r, G)`` like ``fused_round``."""
    G = partial_gram_plain(flat)
    r, coef = gram_coef_plain(G, T, c0, c1, eps)
    return mix_shard_plain(flat, T, coef, out=out), r, G


def fused_round_leaves_plain(leaves, T, c0, c1, eps=1e-12):
    """``fused_round_plain`` on the leaves' (M, n) fp32 view, each leaf's
    columns cast back to its dtype: returns ``(new leaves, r, G)``."""
    M = leaves[0].shape[0]
    flat = torch.cat([l.reshape(M, -1).to(torch.float32) for l in leaves],
                     dim=1)
    out, r, G = fused_round_plain(flat, T, c0, c1, eps, out=flat)
    parts = torch.split(out, [l[0].numel() for l in leaves], dim=1)
    return [p.reshape(l.shape).to(l.dtype)
            for p, l in zip(parts, leaves)], r, G


def sq_dist_plain(x, a):
    """(n,) x, a (fp32 or bf16) -> () fp32 sum of squared differences."""
    d = x.to(torch.float32) - a.to(torch.float32)
    return torch.sum(d * d)


def apply_plain(x, a, coef, out=None):
    """``x + (a − x)·coef`` in fp32, cast to x's dtype. ``out`` may be
    ``x``: the result is formed before it is written."""
    xf = x.to(torch.float32)
    r = xf + (a.to(torch.float32) - xf) * coef
    if out is None:
        return r.to(x.dtype)
    return out.copy_(r)
