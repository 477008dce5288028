from repro_torch.train.autotune import (
    OOM_TOKENS, PLAN_VERSION, Candidate, ProbeResult, TunePlan, TuneSpace,
    autotune, inject_oom_above, is_oom, make_lm_model_fn,
    make_round_probe_runner, per_sample_us,
)
from repro_torch.train.chaos import (
    ChaosEvent, ChaosPlan, FaultInjector, InjectedOOM,
)
from repro_torch.train.clock import (
    OVERLAP_MODES, TAU_SCHEDULES, RoundClock, RoundMetricsLogger, RoundSpec,
)
from repro_torch.train.supervisor import (
    ChaosMembership, HeartbeatMembership, ScheduleMembership, Supervisor,
)
from repro_torch.train.trainer import (
    TrainState, average_params, init_train_state, make_ddp_step,
    make_round_step, make_sharded_round_step, set_participation,
    shard_train_state, sharded_average_params, stacked_params,
    state_template, unshard_params, whole_leaves,
)

__all__ = ["Candidate", "ChaosEvent", "ChaosMembership", "ChaosPlan",
           "FaultInjector", "HeartbeatMembership", "InjectedOOM",
           "OOM_TOKENS", "OVERLAP_MODES", "PLAN_VERSION", "ProbeResult",
           "TAU_SCHEDULES", "RoundClock", "RoundMetricsLogger", "RoundSpec",
           "ScheduleMembership", "Supervisor", "TrainState", "TunePlan",
           "TuneSpace", "autotune", "average_params", "init_train_state",
           "inject_oom_above", "is_oom", "make_ddp_step",
           "make_lm_model_fn", "make_round_probe_runner", "make_round_step",
           "make_sharded_round_step", "per_sample_us", "set_participation",
           "shard_train_state", "sharded_average_params", "stacked_params",
           "state_template", "unshard_params", "whole_leaves"]
