"""Sharpness measures compared against Inv. MV in paper Table 1 / B.1:
Shannon entropy, epsilon-sharpness, Fisher-Rao, LPF, and Hessian-based
(lambda_max / trace / Frobenius via HVP + Lanczos / Hutchinson).

Counterpart of ``repro/core/sharpness.py``. All take ``loss_fn(params,
batch)`` and/or ``logit_fn(params, batch)``. A flat vector follows
``core.engine.tree_items`` order (the reference's ``jax.tree.leaves``
order), so it means the same parameters in both packages. Random vectors
are drawn from an explicit CPU ``torch.Generator`` and then moved to the
parameters' device, so one seed gives the same vectors on the CPU and on
the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import tree_from_items, tree_items


def _flat(tree):
    return torch.cat([l.reshape(-1).to(torch.float32)
                      for _, l in tree_items(tree)])


def _unflat(vec, tree):
    out, i = [], 0
    for path, l in tree_items(tree):
        n = l.numel()
        out.append((path, vec[i:i + n].reshape(l.shape).to(l.dtype)))
        i += n
    return tree_from_items(out)


def _normal(gen, shape, device):
    """Standard normal draws from the CPU generator ``gen``, on ``device``."""
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def _rademacher(gen, shape, device):
    """+-1 draws (fp32) from the CPU generator ``gen``, on ``device``."""
    bits = torch.randint(0, 2, shape, generator=gen)
    return (2.0 * bits.to(torch.float32) - 1.0).to(device)


def _grad(loss_fn, params, batch, *, create_graph=False):
    """Leaves (tree order) of the gradient of ``loss_fn(params, batch)``,
    and those leaves' inputs."""
    ls = [l.detach().requires_grad_(True) for _, l in tree_items(params)]
    p = tree_from_items([(path, l) for (path, _), l in
                         zip(tree_items(params), ls)])
    with torch.enable_grad():
        gs = torch.autograd.grad(loss_fn(p, batch), ls,
                                 create_graph=create_graph,
                                 allow_unused=True)
    return [torch.zeros_like(l) if g is None else g
            for g, l in zip(gs, ls)], ls


# ---------------------------------------------------------------------------

def shannon_entropy(logit_fn, params, batches):
    """Negative mean output entropy (confident nets ~ overfit; B.1)."""
    total, n = 0.0, 0
    with torch.no_grad():
        for b in batches:
            p = torch.softmax(logit_fn(params, b), dim=-1)
            ent = -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)), dim=-1)
            total += float(torch.sum(ent))
            n += int(np.prod(ent.shape))
    return -total / max(n, 1)


def eps_sharpness(loss_fn, params, batch, eps=1e-3, steps=5):
    """Keskar'16-style: max loss in an eps-box via projected ascent,
    normalized: (max - L) / (1 + L) * 100."""
    with torch.no_grad():
        l0 = float(loss_fn(params, batch))
    x = _flat(params)
    box = eps * (torch.abs(x) + 1.0)
    pert = torch.zeros_like(x)
    for _ in range(steps):
        gs, _ = _grad(loss_fn, _unflat(x + pert, params), batch)
        g = torch.cat([t.reshape(-1).to(torch.float32) for t in gs])
        pert = torch.clamp(pert + eps * torch.sign(g) * box, -box, box)
    with torch.no_grad():
        lmax = float(loss_fn(_unflat(x + pert, params), batch))
    return (lmax - l0) / (1.0 + l0) * 100.0


def hvp_fn(loss_fn, params, batch):
    """``hvp(v_tree) -> H v`` (a tree) at ``params``: the gradient's graph
    is built once and differentiated again for each v (reverse over
    reverse; H is symmetric, so this is the reference's forward-over-
    reverse product)."""
    gs, ls = _grad(loss_fn, params, batch, create_graph=True)
    paths = [path for path, _ in tree_items(params)]
    live = [i for i, g in enumerate(gs) if g.requires_grad]

    def hvp(v_tree):
        vs = [v.to(l.dtype) for (_, v), l in zip(tree_items(v_tree), ls)]
        hv = [None] * len(ls)
        if live:        # a gradient with no graph has a zero derivative
            with torch.enable_grad():
                hv = torch.autograd.grad([gs[i] for i in live], ls,
                                         grad_outputs=[vs[i] for i in live],
                                         retain_graph=True,
                                         allow_unused=True)
        return tree_from_items([
            (p, torch.zeros_like(l) if h is None else h.detach())
            for p, h, l in zip(paths, hv, ls)])
    return hvp


def fisher_rao(loss_fn, params, batch):
    """<x, Hx> approximation of the Fisher-Rao norm (Liang'19)."""
    hvp = hvp_fn(loss_fn, params, batch)
    hx = hvp(params)
    return float(sum(torch.sum(a.to(torch.float32) * b.to(torch.float32))
                     for (_, a), (_, b) in zip(tree_items(params),
                                               tree_items(hx))))


def lpf(loss_fn, params, batch, gen, sigma=0.01, mcmc=20):
    """Low-pass-filtered loss (Bisla'22): E_{e~N(0, sigma I)} L(x + e).
    ``gen``: a CPU ``torch.Generator`` (one draw of the flat size per
    sample)."""
    x = _flat(params)
    total = 0.0
    with torch.no_grad():
        for _ in range(mcmc):
            e = sigma * _normal(gen, x.shape, x.device)
            total += float(loss_fn(_unflat(x + e, params), batch))
    return total / mcmc


def lanczos(hvp, dim, gen, iters=20, *, device="cpu"):
    """Lanczos tridiagonalization of the Hessian (via HVP on flat
    vectors). Returns Ritz values (approx extreme eigenvalues)."""
    v = _normal(gen, (dim,), device)
    v = v / torch.linalg.vector_norm(v)
    alphas, betas_l = [], []
    v_prev = torch.zeros_like(v)
    beta = 0.0
    vecs = []
    for _ in range(iters):
        vecs.append(v)
        w = hvp(v)
        alpha = float(torch.dot(w, v))
        w = w - alpha * v - beta * v_prev
        # full reorthogonalization (small iters)
        for u in vecs:
            w = w - torch.dot(w, u) * u
        beta_new = float(torch.linalg.vector_norm(w))
        alphas.append(alpha)
        if beta_new < 1e-8:
            break
        betas_l.append(beta_new)
        v_prev, v, beta = v, w / beta_new, beta_new
    T = np.diag(alphas)
    for i, b in enumerate(betas_l[:len(alphas) - 1]):
        T[i, i + 1] = T[i + 1, i] = b
    return np.linalg.eigvalsh(T)


def hessian_measures(loss_fn, params, batch, gen, lanczos_iters=20,
                     hutchinson=8):
    """lambda_max, trace, and Frobenius-norm estimates of the Hessian.
    ``gen``: a CPU ``torch.Generator`` (the Lanczos start, then one
    Rademacher vector per Hutchinson sample)."""
    hvp_tree = hvp_fn(loss_fn, params, batch)
    x = _flat(params)
    dim = x.shape[0]

    def hvp_vec(v):
        return _flat(hvp_tree(_unflat(v, params)))

    ritz = lanczos(hvp_vec, dim, gen, iters=lanczos_iters, device=x.device)
    lam_max = float(ritz[-1])
    # Hutchinson: trace = E[v^T H v]; frob^2 = E[||Hv||^2], v ~ Rademacher
    tr, fr = 0.0, 0.0
    for _ in range(hutchinson):
        v = _rademacher(gen, (dim,), x.device)
        hv = hvp_vec(v)
        tr += float(torch.dot(v, hv))
        fr += float(torch.sum(hv * hv))
    return {"lambda_max": lam_max, "trace": tr / hutchinson,
            "frob": float(np.sqrt(fr / hutchinson))}


def kendall_tau(a, b):
    """Kendall rank correlation tau-b (paper Table 1 metric), in numpy:
    ``(concordant - discordant) / sqrt((P - ties_a)(P - ties_b))`` over
    the P pairs. NaN for fewer than two values, a NaN input or a constant
    input, as ``scipy.stats.kendalltau``."""
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    if a.size != b.size:
        raise ValueError("kendall_tau needs two sequences of one length")
    if a.size < 2 or np.isnan(a).any() or np.isnan(b).any():
        return float("nan")
    i, j = np.triu_indices(a.size, 1)
    da, db = np.sign(a[i] - a[j]), np.sign(b[i] - b[j])
    pairs = i.size
    den = np.sqrt(float(pairs - np.sum(da == 0))
                  * float(pairs - np.sum(db == 0)))
    if den == 0.0:
        return float("nan")
    return float(np.clip(np.sum(da * db) / den, -1.0, 1.0))
