"""Continuous-batching serving of the port's dense LMs (counterpart of
``repro/serving``)."""
from repro_torch.serving.engine import (
    SlotEngine, decode_key, decode_loop_cache_size, default_chunk, generate,
    make_serve_step, slot_step, slot_step_loop,
)
from repro_torch.serving.sampling import GREEDY, SamplingParams, sample_token
from repro_torch.serving.scheduler import Request, Scheduler, ServeReport, serve

__all__ = [
    "GREEDY", "Request", "SamplingParams", "Scheduler", "ServeReport",
    "SlotEngine", "decode_key", "decode_loop_cache_size", "default_chunk",
    "generate", "make_serve_step", "sample_token", "serve", "slot_step",
    "slot_step_loop",
]
