"""Unified model API (counterpart of ``repro/models/registry.py``).

``build_model(cfg)`` returns a ``ModelAPI``:

    init(gen, device)                           -> params (the reference's tree)
    loss(params, batch)                         -> (loss, metrics)
    prefill(params, batch, buf_len, window=0)   -> (last_logits, states)
    decode_step(params, states, token, index, window=0) -> (logits, states)
    make_state(params, batch, buf_len, window=0) -> (blank states, start)
    prefill_chunk(params, states, tokens, index, window=0) -> (logits, states)

for decoder-only configs whose blocks are all ``attn``/``local_attn``, for
the hybrid one (``mamba`` + ``shared_attn``, zamba2-7b) and for the
recurrent one (``mlstm`` + ``slstm``, xlstm-350m); the other families are
not ported yet. ``batch["tokens"]`` may be a tensor or
a numpy array; the serving lanes move it to the parameters' device. The
serving lanes run without gradients and update ``states`` in place.

``params_from_numpy`` / ``flat_from_numpy`` / ``states_from_numpy`` carry
the JAX package's weights and decode states (as numpy) across, so both
packages compute from the same numbers.
"""
from __future__ import annotations

import dataclasses
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


def _tokens(tokens, device):
    """(B, S) int64 tokens on ``device`` from a tensor or numpy array."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.asarray(tokens))
    return tokens.to(device=device, dtype=torch.int64)


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

    def dev(params):
        return params["embed"].device

    def prefill(params, batch, buf_len, window=0):
        return lm.lm_prefill(cfg, params,
                             _tokens(batch["tokens"], dev(params)), buf_len,
                             prefix=batch.get("prefix"), serve_window=window)

    def decode_step(params, states, token, index, window=0):
        return lm.lm_decode_step(cfg, params, states,
                                 _tokens(token, dev(params)), index,
                                 serve_window=window)

    def make_state(params, batch, buf_len, window=0):
        return lm.lm_make_state(cfg, params, batch["tokens"].shape[0],
                                buf_len, prefix=batch.get("prefix"),
                                serve_window=window)

    def prefill_chunk(params, states, tokens, index, window=0):
        return lm.lm_prefill_chunk(cfg, params, states,
                                   _tokens(tokens, dev(params)), index,
                                   serve_window=window)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill,
                    decode_step=decode_step, make_state=make_state,
                    prefill_chunk=prefill_chunk)


def _to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes: torch can't read it
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)    # a copy


def params_from_numpy(cfg: ModelConfig, tree, *, device, dtype=None):
    """The reference's parameter tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives it) -> the port's params on
    ``device``: leaves the model keeps in its working type in ``dtype``
    (default: ``cfg.dtype``), fp32 leaves (Mamba's ``A_log``, ``D``,
    ``dt_bias``; the xLSTM gates' ``w_i``, ``b_i``, ``w_f``, ``b_f``,
    ``r_gates``, ``b_gates``) in fp32. Raises ``ValueError`` on a missing
    or extra leaf or a shape mismatch."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg,
                                  dtype=str(dtype).removeprefix("torch."))
    return _tree_from_numpy(lm.init_lm(cfg, None, device="meta"), tree,
                            f"parameter tree of {cfg.name}", device)


def _tree_from_numpy(want, tree, what, device):
    """Check a numpy tree against the port's ``want`` (paths and shapes)
    and copy it onto ``device`` in ``want``'s dtypes."""
    want = dict(tree_items(want))
    got = dict(tree_items(tree))
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what} mismatch: missing {missing}, extra "
                         f"{extra}")
    for path, leaf in got.items():
        if tuple(np.shape(leaf)) != tuple(want[path].shape):
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(leaf)} != "
                             f"{tuple(want[path].shape)}")
    return tree_from_items([(p, _to_torch(got[p], device, want[p].dtype))
                            for p in sorted(got)])


def states_from_numpy(cfg: ModelConfig, tree, *, device, dtype=None):
    """The reference's decode states (``jax.tree.map(np.asarray,
    states)`` of ``make_state`` / ``prefill``) -> the port's stacked states
    on ``device``: KV caches and conv states in ``dtype`` (default
    ``cfg.dtype``), ``pos`` int32, SSM and xLSTM states fp32. Batch and
    buffer length are read from the first KV cache of the tree; a tree
    with no KV cache (xlstm) gives its batch from its first leaf and needs
    no buffer length."""
    items = tree_items(tree)
    if not items:
        raise ValueError(f"state tree of {cfg.name} has no leaves")
    path, shape = next(((path, np.shape(leaf)) for path, leaf in items
                        if path[-1] == "k"),
                       (items[0][0], np.shape(items[0][1])))
    lead = 0 if path[0] == "remainder" else 1    # the stacked layer dim
    buf_len = shape[lead + 1] if path[-1] == "k" else 0
    want = lm.init_states(cfg, shape[lead], buf_len,
                          dtype or getattr(torch, cfg.dtype), device="meta")
    return _tree_from_numpy(want, tree, f"state tree of {cfg.name}", device)


def flat_from_numpy(layout, flat, *, device):
    """An ``(R, n)`` flat view from the reference (numpy) -> fp32 tensor on
    ``device``, checked against ``layout``."""
    if tuple(np.shape(flat)) != (layout.R, layout.n):
        raise ValueError(f"flat view shape {np.shape(flat)} != "
                         f"({layout.R}, {layout.n})")
    return _to_torch(flat, device, torch.float32)
