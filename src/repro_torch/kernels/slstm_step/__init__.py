from repro_torch.kernels.slstm_step.ops import slstm_scan
from repro_torch.kernels.slstm_step.ref import slstm_steps_ref
from repro_torch.kernels.slstm_step.slstm_step import (
    HEAD_DIMS, LAUNCHES, build, reset_launches, slstm_steps,
)

__all__ = ["HEAD_DIMS", "LAUNCHES", "build", "reset_launches", "slstm_scan",
           "slstm_steps", "slstm_steps_ref"]
