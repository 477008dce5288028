"""Tensor-parallel serving: one model split over the ranks of a mesh's
``model`` group (the reference's ``model`` axis, which GSPMD splits by
``launch/mesh.py``'s rules; here every split and collective is explicit).

A rank holds its shard of the weights (``launch.mesh.shard_params``,
``tp_split``) and of the KV cache, and runs the model code on a *local*
config (``local_config``): its query heads, its KV heads, its share of
d_ff and of the experts, with the full config's ``head_dim`` and
``d_model`` (the residual stream is whole on every rank). The forward
meets the group at these points:

* the embedding: each rank looks up its d_model columns, then one
  all-gather;
* attention: q / k / v (and qwen2's biases) from the rank's own weight
  columns, attention over its heads (``swa_attention`` at a prefill's
  first chunk), the row-parallel ``wo``, then one all-reduce;
* the gated MLP: column-parallel ``w_gate`` / ``w_up``, row-parallel
  ``w_down``, then one all-reduce;
* a MoE block (expert parallelism): the router's logits all-gathered over
  its split expert dim, so that every rank routes every token alike (the
  same drops), the rank's experts, the combine over them in
  ``cfg.moe_combine_dtype``, one all-reduce in that type, and only then
  the cast to the activations' type; a shared expert is a
  tensor-parallel MLP;
* the head: the rank's vocabulary slice of ``lm_head``, then one
  all-gather of the fp32 logits; with tied embeddings, partial logits
  from the d_model-split ``embed`` and one fp32 all-reduce. Serving asks
  only for the positions sampling reads.

After each collective every rank holds the same numbers, so every rank
samples the same tokens from the same keys. Where the group has more
ranks than the model has KV heads, each KV head is held by the ranks
whose query heads read it (``launch.mesh.placed_apart`` lists those
leaves). Without a ``model`` group, or with one of size 1, ``TP.of``
returns None and the model runs exactly as on one device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import MeshPlan, ModelConfig
from repro_torch.launch import mesh as mesh_lib

# the block kinds and families a model group splits in this port
TP_BLOCKS = ("attn", "local_attn", "moe")


def local_config(cfg: ModelConfig, size: int) -> ModelConfig:
    """A rank's config in a group of ``size``: nq / size query heads,
    max(nkv / size, 1) KV heads, d_ff / size, n_experts / size, and the
    full config's resolved ``head_dim`` (``__post_init__`` resolves 0 from
    the local head count, which would double it)."""
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // size,
        n_kv_heads=max(cfg.n_kv_heads // size, 1),
        d_ff=cfg.d_ff // size, n_experts=cfg.n_experts // size,
        head_dim=cfg.head_dim)


class TP:
    """This rank's part in one model split over its mesh's ``model``
    group: the group, its size and this rank's index in it, the full and
    the local configs, and the group's collectives."""

    def __init__(self, cfg: ModelConfig, mesh, plan: MeshPlan):
        self.group = mesh_lib.model_group(mesh, plan)
        self.size, self.index = self.group.size, self.group.index
        bad = sorted(set(cfg.layer_pattern) - set(TP_BLOCKS))
        if bad or cfg.n_enc_layers or cfg.n_prefix:
            raise ValueError(
                f"{cfg.name}: tensor-parallel serving splits decoder-only "
                f"attention and MoE stacks without a prefix; not "
                f"{bad or ('an encoder' if cfg.n_enc_layers else 'a prefix')}")
        mesh_lib.check_tp(cfg, self.size)
        self.mesh, self.plan = mesh, plan
        self.full, self.cfg = cfg, local_config(cfg, self.size)

    @classmethod
    def of(cls, cfg: ModelConfig, mesh, plan: MeshPlan | None):
        """The ``TP`` of ``mesh``'s model group, or None without a mesh or
        with a group of one."""
        if mesh is None:
            return None
        plan = plan or MeshPlan()
        if mesh_lib.model_group(mesh, plan).size == 1:
            return None
        return cls(cfg, mesh, plan)

    def all_reduce(self, t):
        """``t`` summed over the group, in place."""
        return mesh_lib.all_reduce(t, self.group)

    def all_gather(self, t):
        """The group's ``t``s concatenated along the last dim in rank
        order (the split order of ``tp_split``)."""
        return mesh_lib.all_gather(t, self.group, t.dim() - 1)

    def columns(self, n: int) -> slice:
        """This rank's slice of a dim of ``n`` split in ``size`` parts."""
        step = n // self.size
        return slice(self.index * step, (self.index + 1) * step)

    def __repr__(self):
        return f"TP(size={self.size}, index={self.index}, " \
               f"cfg={self.full.name})"
