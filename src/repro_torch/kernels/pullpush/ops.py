"""Public wrapper: fused DPPF consensus over worker-stacked trees.

Counterpart of ``repro/kernels/pullpush/ops.py``. ``pullpush_fused(stacked,
alpha, lam)`` mirrors ``repro_torch.core.pullpush.pullpush`` but routes the
math through the flat ConsensusEngine: on a CUDA tree one ``fused_round``
call, on a CPU tree the engine's exact gap-space stage (or ``fused_round``'s
plain version with ``use_kernel=True``).

This is the convenience entry point for a one-off call on a tree: it
flattens per call. The training hot path does NOT go through here: the
trainer holds the engine's persistent flat view and calls
``consensus.apply_round(..., engine=...)`` directly, so the flatten happens
once per run.
"""
from __future__ import annotations

import torch

# the module, not the class: core.engine imports this package's kernels,
# so it may still be initializing when this module is imported
from repro_torch.core import engine as _engine


def pullpush_fused(stacked, alpha, lam, *, eps=1e-12, use_kernel=None):
    """Eq. 5 over a worker-stacked tree via the consensus engine. Returns
    ``(new_stacked, r)``: the tree in its leaves' dtypes and the (M,)
    per-worker distances to the worker mean.

    The engine runs in precise mode: this wrapper flattens per call anyway,
    so the fast path's persistent-buffer economy does not apply, and plain
    Eq. 5 holds at every scale (no Gram-noise floor near consensus).
    ``use_kernel`` defaults to "the tree is on CUDA"; a CUDA tree then
    launches the kernel or raises."""
    kw = {} if use_kernel is None else {"use_kernel": use_kernel}
    engine = _engine.ConsensusEngine.from_stacked(stacked, eps=eps,
                                                  precise=True, **kw)
    flat = engine.flatten(stacked)
    M = engine.layout.M
    dev = flat.device
    T = engine.uniform.expand(M, M)
    alpha = torch.full((M,), float(alpha), dtype=torch.float32, device=dev)
    c1 = torch.full((M,), -float(lam), dtype=torch.float32, device=dev)
    new, r, _, _ = engine.stage(flat, T, alpha, c1)
    return engine.unflatten(new), r
