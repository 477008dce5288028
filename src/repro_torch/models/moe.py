"""Mixture-of-Experts MLP: top-k capacity routing with dispatch / combine
products (counterpart of ``repro/models/moe.py``; Switch / Mesh-TF style).

Supports llama4-scout (16 experts, top-1 + a shared expert) and dbrx (16
experts, top-4). The aux load-balance loss follows Switch Transformer:
``E * sum(importance * load)``, the load read from each token's first
choice.

The reference's ``_constrain`` pins the routing tensors' expert dim to a
GSPMD mesh axis (expert parallelism) and is a no-op on one device. Its
counterpart here is explicit: under a ``models.parallel.TP`` a rank holds
E / size experts, routes every token as every other rank does (the
router's logits all-gathered) and sums its experts' part of the combine
with the others' in one all-reduce.
The reference computes the products in jnp outside any Pallas kernel; the
port keeps them as ``torch.bmm`` over the expert (or group) axis, laid out
so that no product copies its operands:

* routing: a softmax router in fp32, the top k of each token (ties go to
  the lower expert index, as ``jax.lax.top_k`` breaks them: a stable
  descending sort), gates renormalised over the k;
* queue positions: token-major cumsums of the one-hot choices; an entry
  at or past the capacity ``C`` is dropped (``keep``): its one-hot row is
  zero, as ``jax.nn.one_hot`` gives for an index out of range;
* ``combine`` (G, Tg, E, C) = gates on kept entries, ``dispatch = combine
  > 0`` in the activations' dtype;
* expert inputs (E, G, C, D), the gated expert MLP, and the combine
  contraction in ``cfg.moe_combine_dtype`` (fp32 in every config).

Tokens are grouped per batch row; a decode step (S == 1) groups over the
batch, so ``C`` depends on the batch there, unless ``per_row``: the slot
engine's batched step routes each row (one token) as its own group, with
capacity ``top_k``, as the reference's vmap over slots sees each slot
alone. ``dropped_entries`` counts what a routing drops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import act_fn, dense_init, init_mlp, mlp


def init_moe(gen, cfg, dtype, *, device):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, device=device),
        "w_gate": dense_init(gen, (e, d, f), dtype, fan_in=d, device=device),
        "w_up": dense_init(gen, (e, d, f), dtype, fan_in=d, device=device),
        "w_down": dense_init(gen, (e, f, d), dtype, fan_in=f, device=device),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, d, f, dtype, device=device)
    return p


def _capacity(tokens_per_group: int, cfg, n_experts: int = 0) -> int:
    """Entries an expert takes from a group; ``n_experts``: all the
    experts, where ``cfg`` is a rank's share of them."""
    e = n_experts or cfg.n_experts
    c = int(tokens_per_group * cfg.top_k / e * cfg.capacity_factor)
    return max(c, cfg.top_k)


def _top_k(probs, k):
    """(values, indices) of the k largest entries of the last dim, in
    descending order, ties to the lower index (``jax.lax.top_k``)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _groups(x, per_row):
    """(G, Tg, D) routing groups of x (B, S, D): the batch rows, or the
    whole batch as one group for a decode step (S == 1) unless
    ``per_row``."""
    B, S, D = x.shape
    return x.reshape(1, B, D) if S == 1 and not per_row else x


def _n_experts(cfg, tp):
    """All the experts: a rank's config holds its share of them."""
    return cfg.n_experts * (tp.size if tp is not None else 1)


def _route(p, xg, cfg, tp=None):
    """Routing of the groups xg (G, Tg, D): (probs, gates (G, Tg, K),
    one-hot choices oh_e (G, Tg, K, E), keep (G, Tg, K) 1.0 for an entry
    within capacity, queue positions (G, Tg, K), capacity C). Under a
    ``TP`` the router holds the rank's experts' columns: their logits are
    all-gathered first, so every rank routes (and drops) alike."""
    G, Tg, _ = xg.shape
    E, K = _n_experts(cfg, tp), cfg.top_k
    C = _capacity(Tg, cfg, E)
    logits = xg.to(torch.float32) @ p["router"]                # (G, Tg, E)
    if tp is not None:
        logits = tp.all_gather(logits)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, K)                               # (G, Tg, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    oh_e = F.one_hot(ids, E).to(torch.float32)                  # (G, Tg, K, E)
    # position of each (token, k) entry within its expert queue, token-major
    flat = oh_e.reshape(G, Tg * K, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos_own = (pos * flat).sum(-1).reshape(G, Tg, K).to(torch.int64)
    keep = (pos_own < C).to(torch.float32)
    return probs, gates, oh_e, keep, pos_own, C


def dropped_entries(p, x, cfg, per_row=False, tp=None):
    """How many (token, choice) entries ``moe_mlp`` drops at capacity on
    x (B, S, D): a 0-d int64 tensor on x's device."""
    keep = _route(p, _groups(x, per_row), cfg, tp)[3]
    return (keep == 0).sum()


def moe_mlp(p, x, cfg, per_row=False, tp=None):
    """x: (B, S, D) -> (out (B, S, D), aux_loss fp32 scalar). ``per_row``:
    a decode step's rows are routed one group each (the slot engine).
    Under a ``TP`` (expert parallelism) the rank runs its own experts and
    contracts the combine over them; the ranks' parts are summed in the
    combine's type before the cast."""
    B, S, D = x.shape
    xg = _groups(x, per_row)
    G, Tg, _ = xg.shape
    K = cfg.top_k
    probs, gates, oh_e, keep, pos_own, C = _route(p, xg, cfg, tp)
    E = cfg.n_experts                             # the rank's experts
    oh_e_own = oh_e if tp is None else oh_e[..., tp.columns(oh_e.shape[-1])]
    # a dropped entry's one-hot row is zero
    oh_c = F.one_hot(torch.clamp(pos_own, max=C - 1), C).to(torch.float32) \
        * keep[..., None]                                       # (G, Tg, K, C)

    # combine[g, t, e, c] = sum_k oh_e[g, t, k, e] gate keep oh_c[g, t, k, c]
    w = oh_e_own * (gates * keep)[..., None]
    combine = torch.bmm(w.reshape(G * Tg, K, E).transpose(1, 2),
                        oh_c.reshape(G * Tg, K, C)).reshape(G, Tg, E, C)
    dispatch = (combine > 0).to(xg.dtype)

    # expert inputs (E, G, C, D): each column of dispatch holds at most one
    # token, so the sum is exact in any order
    ein = torch.einsum("gtec,gtd->egcd", dispatch, xg).reshape(E, G * C, D)
    h = torch.bmm(ein, p["w_gate"])
    u = torch.bmm(ein, p["w_up"])
    h = act_fn(cfg.act)(h) * u
    eout = torch.bmm(h, p["w_down"])                            # (E, G C, D)
    # the combine contraction in cfg.moe_combine_dtype (fp32 in every
    # config: accumulated and returned in fp32)
    cdt = getattr(torch, cfg.moe_combine_dtype)
    eo = eout.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    out = torch.bmm(combine.to(cdt).reshape(G, Tg, E * C), eo.to(cdt))
    if tp is not None:
        out = tp.all_reduce(out)
    out = out.to(x.dtype)

    # Switch aux loss: E * sum_e importance_e * load_e (first choice)
    importance = probs.mean(dim=(0, 1))                         # (E,)
    load = oh_e[:, :, 0, :].mean(dim=(0, 1))
    aux = probs.shape[-1] * torch.sum(importance * load)

    out = out.reshape(B, S, D)
    if cfg.shared_expert:
        out = out + mlp(p["shared"], x, cfg.act, tp)
    return out, aux
