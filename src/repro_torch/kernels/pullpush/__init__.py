from repro_torch.kernels.pullpush.pullpush import (
    LAUNCHES, apply_update, build, fused_round, fused_round_leaves,
    gram_coef, leaf_table, mix_from_gram, mix_shard, partial_gram,
    reset_launches, sq_dist, stale_mix,
)
from repro_torch.kernels.pullpush.ref import (
    apply_plain, fused_round_leaves_plain, fused_round_plain, gram_coef_plain,
    gram_sum_plain, mix_from_gram_plain, mix_shard_plain, partial_gram_plain,
    sq_dist_plain, stale_mix_plain,
)
from repro_torch.kernels.pullpush.ops import pullpush_fused

__all__ = ["LAUNCHES", "apply_plain", "apply_update", "build", "fused_round",
           "fused_round_leaves", "fused_round_leaves_plain",
           "fused_round_plain", "gram_coef", "gram_coef_plain",
           "gram_sum_plain", "leaf_table", "mix_from_gram",
           "mix_from_gram_plain", "mix_shard", "mix_shard_plain",
           "partial_gram", "partial_gram_plain", "pullpush_fused",
           "reset_launches", "sq_dist", "sq_dist_plain", "stale_mix",
           "stale_mix_plain"]
