from repro_torch.train.clock import (
    OVERLAP_MODES, TAU_SCHEDULES, RoundClock, RoundMetricsLogger, RoundSpec,
)
from repro_torch.train.trainer import (
    TrainState, average_params, init_train_state, make_ddp_step,
    make_round_step, set_participation, stacked_params,
)

__all__ = ["OVERLAP_MODES", "TAU_SCHEDULES", "RoundClock",
           "RoundMetricsLogger", "RoundSpec", "TrainState", "average_params",
           "init_train_state", "make_ddp_step", "make_round_step",
           "set_participation", "stacked_params"]
