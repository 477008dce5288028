from repro_torch.train.clock import (
    OVERLAP_MODES, TAU_SCHEDULES, RoundClock, RoundSpec,
)
from repro_torch.train.trainer import (
    TrainState, average_params, init_train_state, make_round_step,
    stacked_params,
)

__all__ = ["OVERLAP_MODES", "TAU_SCHEDULES", "RoundClock", "RoundSpec",
           "TrainState", "average_params", "init_train_state",
           "make_round_step", "stacked_params"]
