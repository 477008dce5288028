from repro_torch.kernels.swa_attention.ops import attention
from repro_torch.kernels.swa_attention.ref import swa_attention_plain
from repro_torch.kernels.swa_attention.swa_attention import (
    LAUNCHES, build, reset_launches, swa_attention,
)

__all__ = ["LAUNCHES", "attention", "build", "reset_launches",
           "swa_attention", "swa_attention_plain"]
