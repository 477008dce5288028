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
  (block-centered Gram, exact at every scale), or ``mix_from_gram`` when
  the Gram is given. It writes the stage into ``flat`` in place — the
  port's counterpart of buffer donation — so the caller's view is
  consumed (``out`` names another buffer). On CPU tensors the wrappers run
  their plain versions, as Pallas interpret mode stands in for the TPU
  kernel.
* fast (default off the card): uncentered Gram + one mixing GEMM, every
  stage distance floored at the Gram's fp32 resolution
  (``GRAM_NOISE_FACTOR``).
* precise: exact gap-space stages (one extra (R, n) buffer).

``use_kernel`` defaults to True exactly when the tensors are on ``cuda``.
fp32 matmuls run at full precision: TF32 would break the fast path's
eps32-derived floor, so it is switched off when this module is imported.

Sharded execution (``shard``, a ``ShardedLayout``): every method then
receives the full-R rows of this rank's column shard, ``(R, n_local)``,
and every column contraction — the Gram, the gap Gram, the distances and
norms — is completed by one ``_colsum``, an all-reduce over the column
group; the (R, R) coefficient math and the mix stay shard-local. The
kernel mode runs ``fused_round_sharded`` there. The worker-row gather at
the round boundary belongs to ``train.trainer.make_sharded_round_step``.
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
# nested-dict / tuple trees (the reference's pytrees)
# ---------------------------------------------------------------------------

def tree_items(tree, prefix=()):
    """``[(key_path, leaf), ...]`` of a tree of dicts and tuples, in the
    order ``jax.tree_util`` flattens it: dict keys sorted at every level,
    tuple elements in order. A tuple element's path entry is its int
    index (an xLSTM state is a tuple of tensors)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, tuple):
        out = []
        for i, sub in enumerate(tree):
            out.extend(tree_items(sub, prefix + (i,)))
        return out
    return [(prefix, tree)]


def _tuples(node):
    """Dicts keyed 0..n-1 by ints (as ``tree_from_items`` builds a tuple's
    elements) back to tuples, at every level."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"tuple indices {sorted(node)} are not "
                             f"0..{len(node) - 1}")
        return tuple(node[i] for i in range(len(node)))
    return node


def tree_from_items(items):
    """Inverse of ``tree_items``: str path entries make dicts, int ones
    tuples."""
    out = {}
    for path, leaf in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return _tuples(out)


def tree_stack(trees):
    """One tree whose leaves stack the given trees' leaves on a new dim 0."""
    items = [tree_items(t) for t in trees]
    return tree_from_items([(path, torch.stack([it[i][1] for it in items]))
                            for i, (path, _) in enumerate(items[0])])


def tree_map(fn, *trees):
    """``jax.tree.map`` over trees of the same structure."""
    items = [tree_items(t) for t in trees]
    return tree_from_items([(path, fn(*(it[i][1] for it in items)))
                            for i, (path, _) in enumerate(items[0])])


def tree_at(tree, i):
    """The views ``leaf[i]`` of a stacked tree: writes through them reach
    the stack."""
    return tree_from_items([(path, leaf[i]) for path, leaf in
                            tree_items(tree)])


@dataclass(frozen=True)
class ShardedLayout:
    """The mesh partition of the flat view on one rank: worker rows over
    ``row_axes`` (``rows`` shards), columns over ``col_axes`` (``cols``
    shards; several axes on a hierarchical mesh), and ``col_group``, this
    rank's ``launch.mesh.Group`` over ``col_axes``, which completes every
    column contraction."""
    row_axes: Tuple[str, ...] = ()
    col_axes: Tuple[str, ...] = ()
    rows: int = 1
    cols: int = 1
    col_group: Any = None


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
    device: str = "cuda"          # where the flat view lives
    # set (dataclasses.replace) by the sharded round: inputs are then
    # (R, n_local) column shards; None = the whole (R, n) view
    shard: Optional[ShardedLayout] = None

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

    def _colsum(self, partial, *, async_op=False):
        """Complete a column contraction: the identity on the whole view,
        the sum over the column group on a shard — the only collective the
        engine issues. ``async_op`` returns a ``launch.mesh.Pending``."""
        from repro_torch.launch import mesh as _mesh
        if self.shard is not None and self.shard.cols > 1:
            return _mesh.all_reduce(partial, self.shard.col_group,
                                    async_op=async_op)
        return _mesh.done(partial) if async_op else partial

    def gram(self, flat):
        """(R, R) uncentered Gram. Only zero-sum quadratic forms of it are
        meaningful; their fp32 noise floor is ~eps32 * max diag."""
        f = flat.to(torch.float32)
        return self._colsum(f @ f.T)

    @staticmethod
    def sq_forms(G, V):
        """r2_i = V_i^T G V_i for each row of V (rows sum to 0 for an
        uncentered or block-centered Gram; any V for a gap Gram)."""
        return torch.clamp(torch.sum((V @ G) * V, dim=1), min=0.0)

    def mix(self, flat, W):
        """x <- W @ x (one GEMM over the flat view)."""
        return W.to(torch.float32) @ flat

    def stage_comm(self, chunk, T, *, async_op=False):
        """The stage's column contraction over a column chunk
        ``x[:, a:b]`` of the flat view — the piece the overlap modes
        dispatch before the round boundary — completed by ``_colsum``.
        Matched to ``stage``'s mode: block-centered ``partial_gram`` read
        in place (kernel), gap Gram (precise), ``f @ f.T`` (fast).
        Disjoint chunks add up to the full-width contraction's zero-sum
        forms, so ``sum_j stage_comm(x[:, j], T)`` feeds ``stage(x, T, c0,
        c1, gram=...)``. ``async_op`` returns the all-reduce's
        ``Pending``."""
        if self.use_kernel:
            part = pk.partial_gram(chunk)
        else:
            f = chunk.to(torch.float32)
            if self.precise:
                f = T.to(torch.float32) @ f - f
            part = f @ f.T
        return self._colsum(part, async_op=async_op)

    def _gap_stage(self, flat, T, c0, c1, *, gram=None):
        """Exact (``precise=True``) stage in gap space: ``tx = T x``,
        distances from ``diag((tx - x)(tx - x)^T)``, the uniform apply
        ``tx + (1 - c)(x - tx)``, pre/post metrics as forms over the gap
        Gram (``gram``: the summed ``stage_comm`` chunks). Requires every
        worker row of T to share one weight vector."""
        R, M = self.layout.R, self.layout.M
        eye = self._eye()
        u = self.uniform
        tx = T @ flat
        Gg = gram
        if Gg is None:
            g = tx - flat
            Gg = self._colsum(g @ g.T)
        r = torch.sqrt(torch.clamp(torch.diagonal(Gg), min=0.0))
        coef = c0 + c1 / torch.clamp(r, min=self.eps)
        new = tx + (1.0 - coef)[:, None] * (flat - tx)
        V_pre = u.expand(R, R) - eye
        pre = torch.mean(torch.sqrt(self.sq_forms(Gg, V_pre)[:M]))
        V_post = torch.diag(coef - 1.0) + (u * (1.0 - coef)).expand(R, R)
        post = torch.mean(torch.sqrt(self.sq_forms(Gg, V_post)[:M]))
        return new, r, pre, post

    def stage(self, flat, T, c0, c1, *, gram=None, base=None, out=None):
        """One fused consensus stage.

        Per row i: ``r_i = ||x_i - T_i x||``, ``coef_i = c0_i + c1_i /
        max(r_i, eps)``, ``x_i <- x_i + coef_i (T_i x - x_i)``.
        Returns ``(new_flat, r, pre_dist, post_dist)`` — pre/post are the
        mean worker distance to the worker mean before/after the stage.

        ``gram`` (the summed ``stage_comm`` chunks, mode-matched) skips the
        column contraction: only the coefficients and the mix run — the
        round-boundary epilogue of the overlap modes. ``base`` (a fresh
        view q) returns the stale delta applied to it, ``q + (new -
        flat)``: in the kernel mode one ``stale_mix`` pass. The kernel
        mode writes into ``out`` (default ``flat`` itself, in place); the
        other modes return new tensors.
        """
        R, M = self.layout.R, self.layout.M
        eye = self._eye()
        Vu = eye - self.uniform.expand(R, R)

        if self.use_kernel:
            out = flat if out is None else out
            if gram is None and self.shard is not None \
                    and self.shard.cols > 1:
                # column shard: partial Gram, its all-reduce over the
                # column group, coefficients and the mix
                new, r, G = pk.fused_round_sharded(
                    flat, T, c0, c1, group=self.shard.col_group,
                    eps=self.eps, out=out, base=base)
            elif gram is None:
                new, r, G = pk.fused_round(flat, T, c0, c1, eps=self.eps,
                                           out=out, base=base)
            else:
                new, r, G = pk.mix_from_gram(flat, T, c0, c1, gram,
                                             eps=self.eps, out=out,
                                             base=base)
            coef = c0 + c1 / torch.clamp(r, min=self.eps)
            W = eye + coef[:, None] * (T - eye)
            pre = torch.mean(torch.sqrt(self.sq_forms(G, Vu)[:M]))
            post = torch.mean(torch.sqrt(self.sq_forms(G, Vu @ W)[:M]))
            return new, r, pre, post

        if self.precise:
            new, r, pre, post = self._gap_stage(flat, T, c0, c1, gram=gram)
        else:
            G = self.gram(flat) if gram is None else gram
            # the floor guards coef only — metrics report the (clamped)
            # forms
            floor = GRAM_NOISE_FACTOR * _EPS32 * torch.max(torch.diagonal(G))
            r = torch.sqrt(torch.maximum(self.sq_forms(G, eye - T), floor))
            coef = c0 + c1 / torch.clamp(r, min=self.eps)
            W = eye + coef[:, None] * (T - eye)
            pre = torch.mean(torch.sqrt(self.sq_forms(G, Vu)[:M]))
            post = torch.mean(torch.sqrt(self.sq_forms(G, Vu @ W)[:M]))
            new = self.mix(flat, W)
        if base is not None:
            new = new.sub_(flat).add_(base)      # q + (new - s)
        return new, r, pre, post

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
        Gg = self._colsum(g @ g.T)
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
        r = torch.sqrt(torch.clamp(self._colsum(torch.sum(v * v, dim=1)),
                                   min=0.0))
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
        d2 = self._colsum(torch.sum(g * g, dim=1))
        return torch.sqrt(torch.clamp(d2, min=0.0))
