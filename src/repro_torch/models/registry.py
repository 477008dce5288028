"""Unified model API (counterpart of ``repro/models/registry.py``).

``build_model(cfg)`` returns a ``ModelAPI``:

    init(gen, device)       -> params (nested dict, the reference's tree)
    loss(params, batch)     -> (loss, metrics)

for decoder-only configs whose blocks are all ``attn``/``local_attn``.
The serving lanes (``prefill``, ``decode_step``, ``make_state``,
``prefill_chunk``) and the other families are not ported yet.

``params_from_numpy`` / ``flat_from_numpy`` carry the JAX package's
weights (as numpy) across, so both packages compute from the same numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import tree_from_items, tree_items
from repro_torch.models import transformer as lm


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    make_state: Callable[..., Any]
    prefill_chunk: Callable[..., Any]


def _serving_not_ported(*args, **kwargs):
    raise NotImplementedError("not yet ported: serving lanes")


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.n_enc_layers or cfg.n_prefix:
        raise NotImplementedError(
            f"not yet ported: {cfg.name} ({cfg.family}: encoder / prefix "
            "inputs)")
    lm._check_supported(cfg)

    def init(gen, device):
        return lm.init_lm(cfg, gen, device=device)

    def loss(params, batch):
        return lm.lm_loss(cfg, params, batch)

    return ModelAPI(cfg=cfg, init=init, loss=loss,
                    prefill=_serving_not_ported,
                    decode_step=_serving_not_ported,
                    make_state=_serving_not_ported,
                    prefill_chunk=_serving_not_ported)


def _to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: torch can't read it
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)    # a copy


def params_from_numpy(cfg: ModelConfig, tree, *, device, dtype=None):
    """The reference's parameter tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives it) -> the port's params on
    ``device`` in ``dtype`` (default: ``cfg.dtype``). Raises ``ValueError``
    on a missing or extra leaf or a shape mismatch."""
    want = dict(tree_items(lm.init_lm(cfg, None, device="meta")))
    got = dict(tree_items(tree))
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch for {cfg.name}: missing "
                         f"{missing}, extra {extra}")
    for path, leaf in got.items():
        if tuple(np.shape(leaf)) != tuple(want[path].shape):
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(leaf)} != "
                             f"{tuple(want[path].shape)}")
    dtype = dtype or getattr(torch, cfg.dtype)
    return tree_from_items([(p, _to_torch(got[p], device, dtype))
                            for p in sorted(got)])


def flat_from_numpy(layout, flat, *, device):
    """An ``(R, n)`` flat view from the reference (numpy) -> fp32 tensor on
    ``device``, checked against ``layout``."""
    if tuple(np.shape(flat)) != (layout.R, layout.n):
        raise ValueError(f"flat view shape {np.shape(flat)} != "
                         f"({layout.R}, {layout.n})")
    return _to_torch(flat, device, torch.float32)
