"""Stand-ins for every model input, as ``meta`` tensors: the dry-run's
inputs (counterpart of ``repro/launch/specs.py``).

``input_specs(cfg, shape, plan, mode, n_workers, tau)`` returns tensors on
the ``meta`` device (shapes and dtypes, no memory) for each workload:

  train   -> the DPPF round batch (tau, M, B_local, S) [+ modality stubs]
  ddp     -> the per-step batch (M, B_local, S)
  prefill -> the (B, S) prompt batch
  decode  -> (token, index, states), the KV cache of the shape's length
             (or the sliding-window ring of the long_500k variant)

where the reference returns ``jax.ShapeDtypeStruct``s. Given a ``mesh``
(a ``launch.mesh.VirtualMesh``) whose ``model`` group splits the model,
the parameter and state specs are one rank's shard, as the reference's
``param_shardings`` / ``serve_shardings`` place them over its mesh. Modality frontends
are stubs, as in the reference: the specs hold the frame / patch
embeddings themselves.

Dtypes follow the port, which differs from the reference in one place
(``DTYPE_MAP``): token and label ids and the decode index are int64
(``torch.int64``, the dtype the port's embedding lookup and loss take)
where the reference's are int32. Everything else keeps the reference's
dtype name: parameters in the config's dtype (fp32 leaves where the model
keeps them), the cache's ``pos`` int32, frames and prefixes fp32. The
decode step takes its index as a host int; its spec is a 0-dim tensor.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, MeshPlan, ModelConfig
from repro_torch.models import build_model

TOK = torch.int64
META = torch.device("meta")
# reference dtype name -> port dtype name, where they differ
DTYPE_MAP = {"int32": "int64"}


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def serve_window_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Sub-quadratic policy for long_500k: recurrent archs keep their
    native O(1) / full-cache path; dense archs serve with a sliding
    window (gemma2 its native 4096)."""
    if shape.name != "long_500k":
        return 0
    if cfg.is_recurrent:
        return 0
    return cfg.sliding_window or 8192


def buf_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    w = serve_window_for(cfg, shape)
    if w:
        return w
    # decoder-only prefix archs (vlm / audio stubs) cache prefix + tokens
    extra = cfg.n_prefix if not cfg.n_enc_layers else 0
    return shape.seq_len + extra


def _modality_specs(cfg: ModelConfig, lead: tuple):
    out = {}
    if cfg.n_enc_layers:
        out["enc"] = _meta(lead + (cfg.n_prefix, cfg.d_model), torch.float32)
    elif cfg.n_prefix:
        out["prefix"] = _meta(lead + (cfg.n_prefix, cfg.d_model),
                              torch.float32)
    return out


def train_batch_specs(cfg: ModelConfig, shape: InputShape, n_workers: int,
                      tau: int, *, per_step=False):
    if shape.global_batch % n_workers:
        raise ValueError(
            f"{shape.name}: global batch {shape.global_batch} not divisible "
            f"by {n_workers} workers")
    b_local = shape.global_batch // n_workers
    lead = (n_workers, b_local) if per_step else (tau, n_workers, b_local)
    specs = {"tokens": _meta(lead + (shape.seq_len,), TOK),
             "labels": _meta(lead + (shape.seq_len,), TOK)}
    specs.update(_modality_specs(cfg, lead))
    return specs


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape):
    lead = (shape.global_batch,)
    specs = {"tokens": _meta(lead + (shape.seq_len,), TOK)}
    specs.update(_modality_specs(cfg, lead))
    return specs


def param_specs(cfg: ModelConfig, mesh=None, plan=None):
    """The model's parameter tree on ``meta`` (the reference's tree paths,
    as ``models.registry.params_from_numpy`` names them); with a ``mesh``
    whose ``model`` group splits the model, this rank's shard."""
    return build_model(cfg, mesh, plan).init(None, META)


def decode_state_specs(cfg: ModelConfig, shape: InputShape, params=None,
                       mesh=None, plan=None):
    """The decode states on ``meta``: ``make_state`` of the shape's batch
    at its buffer length (an enc-dec model's cross-attention cache from
    its frames), which has the structure a prefill leaves; with a
    ``mesh`` whose ``model`` group splits the model, this rank's KV
    heads."""
    model = build_model(cfg, mesh, plan)
    params = param_specs(cfg, mesh, plan) if params is None else params
    batch = {"tokens": _meta((shape.global_batch, 1), TOK)}
    batch.update(_modality_specs(cfg, (shape.global_batch,)))
    batch.pop("prefix", None)      # decode states do not hold the prefix
    states, _ = model.make_state(params, batch, buf_len_for(cfg, shape),
                                 window=serve_window_for(cfg, shape))
    return states


def decode_step_specs(cfg: ModelConfig, shape: InputShape, params=None,
                      mesh=None, plan=None):
    token = _meta((shape.global_batch, 1), TOK)
    index = _meta((), TOK)
    return token, index, decode_state_specs(cfg, shape, params, mesh, plan)


def input_specs(cfg: ModelConfig, shape: InputShape, plan: MeshPlan,
                mode: str, n_workers: int, tau: int = 4):
    if mode == "train":
        return train_batch_specs(cfg, shape, n_workers, tau)
    if mode == "ddp":
        return train_batch_specs(cfg, shape, n_workers, tau, per_step=True)
    if mode == "prefill":
        return prefill_batch_specs(cfg, shape)
    if mode == "decode":
        return decode_step_specs(cfg, shape)
    raise ValueError(mode)
