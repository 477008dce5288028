"""ConsensusEngine: flat, one-pass consensus for every DPPF method.

Counterpart of ``repro/core/engine.py``. The worker parameters live in ONE
persistent ``(R, n)`` fp32 view for the whole run: ``flatten`` builds it
once, its first ``M`` rows are the workers and optional aux rows carry
row-shaped consensus state (the EASGD/Parle center). Columns follow the
reference's leaf order — dict leaves sorted by key path, as
``jax.tree_util`` flattens a dict — so an ``(R, n)`` view from either
package matches the other column for column.

Every consensus method lowers (``core/consensus.py``) to stages
``x <- W x`` with ``W = I + diag(coef)(T - I)``, ``T`` row-stochastic and
``coef = c0 + c1 / max(r, eps)``. Three execution modes, as in the
reference:

* kernel (``use_kernel``): the hand-written CUDA ``fused_round``
  (block-centered Gram, exact at every scale). It writes the stage into
  ``flat`` in place — the port's counterpart of buffer donation — so the
  caller's view is consumed. On CPU tensors the wrapper runs its plain
  version, as Pallas interpret mode stands in for the TPU kernel.
* fast (default off the card): uncentered Gram + one mixing GEMM, every
  stage distance floored at the Gram's fp32 resolution
  (``GRAM_NOISE_FACTOR``).
* precise: exact gap-space stages (one extra (R, n) buffer).

``use_kernel`` defaults to True exactly when the tensors are on ``cuda``.
fp32 matmuls run at full precision: TF32 would break the fast path's
eps32-derived floor, so it is switched off when this module is imported.
Multi-GPU execution (``shard``) is not ported yet and must stay ``None``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.pullpush import pullpush as pk

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

GRAM_NOISE_FACTOR = 256.0
_EPS32 = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# nested-dict parameter trees (the reference's pytrees)
# ---------------------------------------------------------------------------

def tree_items(tree, prefix=()):
    """``[(key_path, leaf), ...]`` of a nested dict, in the order
    ``jax.tree_util`` flattens a dict: keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_from_items(items):
    """Inverse of ``tree_items``."""
    out = {}
    for path, leaf in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


@dataclass(frozen=True)
class FlatLayout:
    """Static description of the flat view (hashable)."""
    paths: Tuple[Tuple[str, ...], ...]   # leaf key paths, flatten order
    shapes: Tuple[Tuple[int, ...], ...]  # per-leaf shapes WITHOUT worker dim
    dtypes: Tuple[str, ...]
    offsets: Tuple[int, ...]
    n: int            # parameters per worker
    M: int            # workers
    aux: int = 0      # extra state rows (easgd center)

    @property
    def R(self) -> int:
        return self.M + self.aux

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@dataclass(frozen=True)
class ConsensusEngine:
    layout: FlatLayout
    use_kernel: bool = False      # CUDA fused_round vs torch Gram+GEMM
    precise: bool = False         # torch path: exact gap-space stages
    eps: float = 1e-12
    device: str = "cpu"           # where the flat view lives
    shard: Optional[Any] = None   # multi-GPU layout: not ported yet

    def __post_init__(self):
        if self.shard is not None:
            raise NotImplementedError("not yet ported: sharded engine")

    # -- construction -------------------------------------------------------

    @classmethod
    def from_stacked(cls, stacked, *, method: str = "simple_avg", **kw):
        """Build the layout from a worker-stacked tree (leaves (M, ...))."""
        items = tree_items(stacked)
        leaves = [l for _, l in items]
        M = leaves[0].shape[0]
        shapes = tuple(tuple(l.shape[1:]) for l in leaves)
        offsets, o = [], 0
        for s in shapes:
            offsets.append(o)
            o += math.prod(s)
        from repro_torch.core.methods import get_method
        aux = get_method(method).aux_rows
        device = leaves[0].device
        kw.setdefault("use_kernel", device.type == "cuda")
        kw.setdefault("device", str(device))
        layout = FlatLayout(paths=tuple(p for p, _ in items), shapes=shapes,
                            dtypes=tuple(_dtype_name(l.dtype) for l in leaves),
                            offsets=tuple(offsets), n=o, M=M, aux=aux)
        return cls(layout=layout, **kw)

    # -- flat view management (flatten happens ONCE per training run) -------

    def flatten(self, stacked):
        """Stacked tree -> (R, n) fp32. Leaves are copied straight into one
        preallocated buffer (a broadcast ``expand`` of one model costs no
        memory). Aux rows are initialized to the worker mean."""
        L = self.layout
        flat = torch.empty((L.R, L.n), dtype=torch.float32,
                           device=self.device)
        for (path, leaf), off, size in zip(tree_items(stacked), L.offsets,
                                           L.sizes):
            flat[:L.M, off:off + size].copy_(leaf.reshape(L.M, size))
        if L.aux:
            flat[L.M:] = torch.mean(flat[:L.M], dim=0, keepdim=True)
        return flat

    def unflatten(self, flat):
        """Worker rows of the flat view -> stacked tree (original dtypes)."""
        L = self.layout
        rows = flat[:L.M]
        return tree_from_items([
            (path, rows[:, off:off + size].reshape((L.M,) + shape)
             .to(getattr(torch, dtype)))
            for path, shape, dtype, off, size in zip(
                L.paths, L.shapes, L.dtypes, L.offsets, L.sizes)])

    def unflatten_row(self, row, *, cast=True):
        """One (n,) row -> parameter tree without the worker dim.
        ``torch.split`` views, so a gradient through them arrives as ONE
        (n,) tensor. ``cast=False`` keeps fp32 leaves."""
        L = self.layout
        parts = torch.split(row, L.sizes)
        return tree_from_items([
            (path, part.view(shape).to(getattr(torch, dtype))
             if cast else part.view(shape))
            for path, part, shape, dtype in zip(L.paths, parts, L.shapes,
                                                L.dtypes)])

    def workers(self, flat):
        return flat[:self.layout.M]

    def with_workers(self, flat, rows):
        """The flat view with its worker rows replaced (a new buffer when
        there are aux rows; the trainer itself updates rows in place)."""
        if not self.layout.aux:
            return rows
        out = flat.clone()
        out[:self.layout.M] = rows
        return out

    # -- flat math primitives ------------------------------------------------

    @property
    def uniform(self):
        """(R,) uniform weights over worker rows (zeros on aux rows)."""
        L = self.layout
        u = torch.zeros((L.R,), dtype=torch.float32, device=self.device)
        u[:L.M] = 1.0 / L.M
        return u

    def _eye(self):
        return torch.eye(self.layout.R, dtype=torch.float32,
                         device=self.device)

    def gram(self, flat):
        """(R, R) uncentered Gram. Only zero-sum quadratic forms of it are
        meaningful; their fp32 noise floor is ~eps32 * max diag."""
        f = flat.to(torch.float32)
        return f @ f.T

    @staticmethod
    def sq_forms(G, V):
        """r2_i = V_i^T G V_i for each row of V (rows sum to 0 for an
        uncentered or block-centered Gram; any V for a gap Gram)."""
        return torch.clamp(torch.sum((V @ G) * V, dim=1), min=0.0)

    def mix(self, flat, W):
        """x <- W @ x (one GEMM over the flat view)."""
        return W.to(torch.float32) @ flat

    def _gap_stage(self, flat, T, c0, c1):
        """Exact (``precise=True``) stage in gap space: ``tx = T x``,
        distances from ``diag((tx - x)(tx - x)^T)``, the uniform apply
        ``tx + (1 - c)(x - tx)``, pre/post metrics as forms over the gap
        Gram. Requires every worker row of T to share one weight vector."""
        R, M = self.layout.R, self.layout.M
        eye = self._eye()
        u = self.uniform
        tx = T @ flat
        g = tx - flat
        Gg = g @ g.T
        r = torch.sqrt(torch.clamp(torch.diagonal(Gg), min=0.0))
        coef = c0 + c1 / torch.clamp(r, min=self.eps)
        new = tx + (1.0 - coef)[:, None] * (flat - tx)
        V_pre = u.expand(R, R) - eye
        pre = torch.mean(torch.sqrt(self.sq_forms(Gg, V_pre)[:M]))
        V_post = torch.diag(coef - 1.0) + (u * (1.0 - coef)).expand(R, R)
        post = torch.mean(torch.sqrt(self.sq_forms(Gg, V_post)[:M]))
        return new, r, pre, post

    def stage(self, flat, T, c0, c1, *, gram=None):
        """One fused consensus stage.

        Per row i: ``r_i = ||x_i - T_i x||``, ``coef_i = c0_i + c1_i /
        max(r_i, eps)``, ``x_i <- x_i + coef_i (T_i x - x_i)``.
        Returns ``(new_flat, r, pre_dist, post_dist)`` — pre/post are the
        mean worker distance to the worker mean before/after the stage.
        The kernel mode returns ``flat`` itself, updated in place.
        """
        if gram is not None:
            raise NotImplementedError(
                "not yet ported: precomputed-Gram stages (overlap modes)")
        R, M = self.layout.R, self.layout.M
        eye = self._eye()
        Vu = eye - self.uniform.expand(R, R)

        if self.use_kernel:
            new, r, G = pk.fused_round(flat, T, c0, c1, eps=self.eps,
                                       out=flat)
            coef = c0 + c1 / torch.clamp(r, min=self.eps)
            W = eye + coef[:, None] * (T - eye)
            pre = torch.mean(torch.sqrt(self.sq_forms(G, Vu)[:M]))
            post = torch.mean(torch.sqrt(self.sq_forms(G, Vu @ W)[:M]))
            return new, r, pre, post

        if self.precise:
            return self._gap_stage(flat, T, c0, c1)

        G = self.gram(flat)
        # the floor guards coef only — metrics report the (clamped) forms
        floor = GRAM_NOISE_FACTOR * _EPS32 * torch.max(torch.diagonal(G))
        r = torch.sqrt(torch.maximum(self.sq_forms(G, eye - T), floor))
        coef = c0 + c1 / torch.clamp(r, min=self.eps)
        W = eye + coef[:, None] * (T - eye)
        pre = torch.mean(torch.sqrt(self.sq_forms(G, Vu)[:M]))
        post = torch.mean(torch.sqrt(self.sq_forms(G, Vu @ W)[:M]))
        return self.mix(flat, W), r, pre, post

    def exact_stage(self, flat, lam_r):
        """Exact two-term push (Appendix E.1): x_m += (lam_r / M)
        (u_m - mean u), u_m = (x_m - mean x)/r_m. Gap-space (exact).
        Returns ``(new_flat, r, pre_dist, post_dist)``."""
        R, M = self.layout.R, self.layout.M
        eye = self._eye()
        u = self.uniform
        T = u.expand(R, R)
        if self.layout.aux:
            T = torch.cat([T[:M], eye[M:]], dim=0)
        g = T @ flat - flat                       # worker rows: mean - x_m
        Gg = g @ g.T
        r = torch.sqrt(torch.clamp(torch.diagonal(Gg), min=0.0))
        inv = 1.0 / torch.clamp(r, min=self.eps)
        units = -g[:M] * inv[:M, None]            # (x_m - mean)/r_m
        mean_unit = torch.mean(units, dim=0, keepdim=True)
        upd = (lam_r / M) * (units - mean_unit)
        new = flat.clone()
        new[:M] += upd
        pre = torch.mean(r[:M])
        iv = torch.where(torch.arange(R, device=flat.device) < M, inv,
                         torch.zeros_like(inv))
        V_post = (-torch.diag(1.0 + (lam_r / M) * iv)
                  + ((lam_r / M) * (u * iv)).expand(R, R))
        post = torch.mean(torch.sqrt(self.sq_forms(Gg, V_post)[:M]))
        return new, r, pre, post

    def vec_stage(self, flat, vec, cvec):
        """Push along an EXTERNAL per-worker direction field (LPF-SGD's
        EMA-filtered gradient): row m moves by
        ``(cvec_m / max(r_m, eps)) * vec_m`` with ``r_m = ||vec_m||``.
        Returns ``(new_flat, r, pre_dist, post_dist)`` like ``stage``."""
        M = self.layout.M
        v = vec.to(torch.float32)
        r = torch.sqrt(torch.clamp(torch.sum(v * v, dim=1), min=0.0))
        upd = (cvec[:M] / torch.clamp(r, min=self.eps))[:, None] * v
        pre = torch.mean(self.dists_to_mean(flat))
        new = flat.clone()
        new[:M] += upd
        post = torch.mean(self.dists_to_mean(new))
        return new, r, pre, post

    def dists_to_mean(self, flat):
        """Exact per-worker distances to the worker mean (gap-space)."""
        M = self.layout.M
        w = flat[:M].to(torch.float32)
        g = torch.mean(w, dim=0, keepdim=True) - w
        d2 = torch.sum(g * g, dim=1)
        return torch.sqrt(torch.clamp(d2, min=0.0))
