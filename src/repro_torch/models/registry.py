"""Unified model API (counterpart of ``repro/models/registry.py``).

``build_model(cfg)`` returns a ``ModelAPI``:

    init(gen, device)                           -> params (the reference's tree)
    loss(params, batch)                         -> (loss, metrics)
    prefill(params, batch, buf_len, window=0)   -> (last_logits, states)
    decode_step(params, states, token, index, window=0, active=None)
                                                -> (logits, states)
    make_state(params, batch, buf_len, window=0) -> (blank states, start)
    prefill_chunk(params, states, tokens, index, window=0) -> (logits, states)

for every family: decoder-only (``models/transformer.py``: dense, MoE,
hybrid, recurrent, and vlm with its prefix) and encoder-decoder
(``models/encdec.py``, seamless-m4t). ``batch`` holds ``tokens`` (B, S),
``labels`` (B, S) for the loss, and the stubbed modality inputs: ``prefix``
(B, P, D) for a vlm, ``enc`` (B, F, D) frames for an enc-dec model.
``make_state`` primes a state with them, so its ``start`` is the first
token's position. The serving lanes take tensors or numpy arrays and move
them to the parameters' device; they run without gradients and update
``states`` in place.

``decode_step``'s ``index`` has two meanings. A Python int is one
position for the whole batch (``generate``; a MoE decode step routes the
batch as one group). A (B,) int array or tensor gives each row its own
position: the slot engine's batched step over its ``max_slots`` rows, as
the reference's vmap over slots. Then ``states`` carry per-row (B, buf)
``pos`` tags, each row is its own MoE routing group (capacity
``top_k``), and the rows where the (B,) bool ``active`` is False come out
with every state unchanged. ``state_batch_axes`` says where a state
tree's batch axis lies, leaf by leaf.

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
from repro_torch.models import encdec as encdec_lib
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


def _context(batch, params, key):
    """The batch's stubbed modality input ``key`` (a tensor or numpy
    array, or absent) on the parameters' device; numpy arrays as fp32."""
    x = batch.get(key)
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(params["embed"].device)


def _init_fn(cfg):
    return encdec_lib.init_encdec if cfg.n_enc_layers else lm.init_lm


def build_model(cfg: ModelConfig) -> ModelAPI:
    # the family's lanes; both modules take the modality input by the
    # keyword that names its batch entry
    if cfg.n_enc_layers:
        key, lanes = "enc", (encdec_lib.encdec_loss,
                             encdec_lib.encdec_prefill,
                             encdec_lib.encdec_decode_step,
                             encdec_lib.encdec_make_state,
                             encdec_lib.encdec_prefill_chunk)
    else:
        key, lanes = "prefix", (lm.lm_loss, lm.lm_prefill,
                                lm.lm_decode_step, lm.lm_make_state,
                                lm.lm_prefill_chunk)
    loss_fn, prefill_fn, decode_fn, make_state_fn, chunk_fn = lanes

    def init(gen, device):
        return _init_fn(cfg)(cfg, gen, device=device)

    def dev(params):
        return params["embed"].device

    def loss(params, batch):
        return loss_fn(cfg, params, batch)

    def prefill(params, batch, buf_len, window=0):
        return prefill_fn(cfg, params, _tokens(batch["tokens"], dev(params)),
                          buf_len, serve_window=window,
                          **{key: _context(batch, params, key)})

    def decode_step(params, states, token, index, window=0, active=None):
        if np.ndim(index) == 1:
            index = torch.as_tensor(index).to(dev(params))
        if active is not None:
            active = torch.as_tensor(active).to(dev(params), torch.bool)
        return decode_fn(cfg, params, states, _tokens(token, dev(params)),
                         index, serve_window=window, active=active)

    def make_state(params, batch, buf_len, window=0):
        return make_state_fn(cfg, params, batch["tokens"].shape[0], buf_len,
                             serve_window=window,
                             **{key: _context(batch, params, key)})

    def prefill_chunk(params, states, tokens, index, window=0):
        return chunk_fn(cfg, params, states, _tokens(tokens, dev(params)),
                        index, serve_window=window)

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
    ``r_gates``, ``b_gates``; the MoE ``router``) in fp32. Enc-dec
    configs take the reference's enc-dec tree. Raises ``ValueError`` on a
    missing or extra leaf or a shape mismatch."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg,
                                  dtype=str(dtype).removeprefix("torch."))
    return _tree_from_numpy(_init_fn(cfg)(cfg, None, device="meta"), tree,
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
    buffer length are read from the first KV cache of the tree (an enc-dec
    tree's ``self`` cache; its frames from ``ck``, whose (L, B, F, nkv, hd)
    is no cache); a tree with no KV cache (xlstm) gives its batch from its
    first leaf and needs no buffer length."""
    items = tree_items(tree)
    if not items:
        raise ValueError(f"state tree of {cfg.name} has no leaves")
    path, shape = next(((path, np.shape(leaf)) for path, leaf in items
                        if path[-1] == "k"),
                       (items[0][0], np.shape(items[0][1])))
    lead = 0 if path[0] == "remainder" else 1    # the stacked layer dim
    buf_len = shape[lead + 1] if path[-1] == "k" else 0
    dtype = dtype or getattr(torch, cfg.dtype)
    if cfg.n_enc_layers:
        frames = np.shape(tree["ck"])[2] if "ck" in tree else 0
        want = encdec_lib.init_states(cfg, shape[lead], buf_len, frames,
                                      dtype, device="meta")
    else:
        want = lm.init_states(cfg, shape[lead], buf_len, dtype,
                              device="meta")
    return _tree_from_numpy(want, tree, f"state tree of {cfg.name}", device)


def state_batch_axes(cfg: ModelConfig):
    """``{path: axis}`` of a decode-state tree (``make_state`` /
    ``prefill``): each leaf's batch axis, None for a ``pos`` tag, which
    the batch shares. Read off two meta-device trees of batch 1 and 2."""
    def meta(batch):
        if cfg.n_enc_layers:
            return encdec_lib.init_states(cfg, batch, 1, 1, torch.float32,
                                          device="meta")
        return lm.init_states(cfg, batch, 1, torch.float32, device="meta")
    two = dict(tree_items(meta(2)))
    return {path: next((ax for ax, (a, b) in enumerate(zip(
                leaf.shape, two[path].shape)) if a != b), None)
            for path, leaf in tree_items(meta(1))}


def flat_from_numpy(layout, flat, *, device):
    """An ``(R, n)`` flat view from the reference (numpy) -> fp32 tensor on
    ``device``, checked against ``layout``."""
    if tuple(np.shape(flat)) != (layout.R, layout.n):
        raise ValueError(f"flat view shape {np.shape(flat)} != "
                         f"({layout.R}, {layout.n})")
    return _to_torch(flat, device, torch.float32)
