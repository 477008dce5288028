from repro_torch.kernels.pullpush.pullpush import (
    LAUNCHES, build, fused_round, gram_coef, mix_shard, partial_gram,
    reset_launches,
)
from repro_torch.kernels.pullpush.ref import (
    fused_round_plain, gram_coef_plain, mix_shard_plain, partial_gram_plain,
)

__all__ = ["LAUNCHES", "build", "fused_round", "fused_round_plain",
           "gram_coef", "gram_coef_plain", "mix_shard", "mix_shard_plain",
           "partial_gram", "partial_gram_plain", "reset_launches"]
