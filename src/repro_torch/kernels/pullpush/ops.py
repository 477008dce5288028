"""Public wrapper: fused DPPF consensus over worker-stacked trees.

Counterpart of ``repro/kernels/pullpush/ops.py``. ``pullpush_fused(stacked,
alpha, lam)`` mirrors ``repro_torch.core.pullpush.pullpush`` (Eq. 5): one
consensus stage over the tree's virtual (M, n) view. On a CUDA tree it is
two launches over the tree's own leaves (``fused_round_leaves``: the
partial Gram with its coefficient tail, then the mix into a new tree in
the leaves' dtypes), with no flattened copy; on a CPU tree their plain
version, the flatten, ``fused_round_plain`` and the cast back.
``use_kernel=False`` takes the engine's exact gap-space stage instead
(the reference's jnp branch).

This is the convenience entry point for a one-off call on a tree. The
training hot path does NOT go through here: the trainer holds the
engine's persistent flat view and calls ``consensus.apply_round(...,
engine=...)`` directly, so the flatten happens once per run.
"""
from __future__ import annotations

import torch

# the module, not the class: core.engine imports this package's kernels,
# so it may still be initializing when this module is imported
from repro_torch.core import engine as _engine
from repro_torch.kernels.pullpush import pullpush as _pk


def pullpush_fused(stacked, alpha, lam, *, eps=1e-12, use_kernel=None):
    """Eq. 5 over a worker-stacked tree. Returns ``(new_stacked, r)``: the
    tree in its leaves' dtypes and the (M,) per-worker distances to the
    worker mean.

    ``use_kernel`` (default True): the kernel route, ``fused_round`` on the
    tree's (M, n) view as ``fused_round_leaves`` runs it (the kernels on a
    CUDA tree, which launch or raise; their plain version on a CPU tree).
    ``use_kernel=False``: the engine's precise stage on a flattened view
    (plain Eq. 5 in gap space)."""
    items = _engine.tree_items(stacked)
    if use_kernel is False:
        engine = _engine.ConsensusEngine.from_stacked(
            stacked, eps=eps, precise=True, use_kernel=False)
        flat = engine.flatten(stacked)
        M = engine.layout.M
        dev = flat.device
        T = engine.uniform.expand(M, M)
        c0 = torch.full((M,), float(alpha), dtype=torch.float32, device=dev)
        c1 = torch.full((M,), -float(lam), dtype=torch.float32, device=dev)
        new, r, _, _ = engine.stage(flat, T, c0, c1)
        return engine.unflatten(new), r
    leaves = [leaf for _, leaf in items]
    M, dev = _pk.leaf_table(leaves).M, leaves[0].device
    T = torch.full((M, M), 1.0 / M, dtype=torch.float32, device=dev)
    c0 = torch.full((M,), float(alpha), dtype=torch.float32, device=dev)
    c1 = torch.full((M,), -float(lam), dtype=torch.float32, device=dev)
    new, r, _ = _pk.fused_round_leaves(leaves, T, c0, c1, eps)
    return _engine.tree_from_items(
        [(path, leaf) for (path, _), leaf in zip(items, new)]), r
