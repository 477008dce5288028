"""Host-side scheduler for the continuous-batching SlotEngine (counterpart
of ``repro/serving/scheduler.py``).

``Scheduler`` owns the FIFO request queue and the per-slot host mirrors
(prompt tail being fed, tokens kept so far); ``serve`` drives the engine's
lanes step by step. Two packing modes:

* ``continuous`` — a request is admitted the moment a slot frees up,
  mid-decode of everything else.
* ``static``    — classic static batching: admit a full batch, then
  barrier until EVERY slot finishes before admitting the next batch.

Both modes run the same decode step, so their step counts are a
structural (timer-free) measure of scheduling efficiency: on mixed-length
traces continuous needs no more steps than static. Wall-clock times are
taken around ``torch.cuda.synchronize()`` when the engine runs on a card.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.serving.engine import SlotEngine
from repro_torch.serving.sampling import fold_in

MODES = ("continuous", "static")


@dataclass
class Request:
    """One serving request. ``key`` (an int seed) seeds the slot's sampling
    lanes; None derives one from the stream key by rid, so results are
    independent of slot placement and co-residents."""
    rid: int
    tokens: np.ndarray
    max_new_tokens: int
    key: int | None = None

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens).reshape(-1)
        if self.tokens.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}")


@dataclass
class RequestResult:
    rid: int
    tokens: list
    ttft_s: float
    admitted_step: int
    finished_step: int


@dataclass
class ServeReport:
    results: dict
    steps: int
    generated: int
    occupancy: float      # active slot-steps / (steps * max_slots)
    wall_s: float
    tok_s: float
    ttft_mean_s: float
    mode: str


@dataclass
class _SlotRec:
    req: Request
    tail: list
    fed: int
    out: list = field(default_factory=list)
    admitted_step: int = 0
    ttft_s: float = 0.0


class Scheduler:
    """FIFO queue + slot table. ``free_slots`` packs free slots from the
    queue (continuous: any free slot, any time; static: only when the
    whole table is empty)."""

    def __init__(self, max_slots: int, mode: str = "continuous"):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.max_slots = max_slots
        self.mode = mode
        self.queue = deque()
        self.table = [None] * max_slots

    def submit(self, req: Request, engine: SlotEngine):
        if engine.window == 0:
            total = engine.start0 + req.tokens.size + req.max_new_tokens
            if total > engine.buf_len:
                raise ValueError(
                    f"request {req.rid}: {total} total positions exceed "
                    f"buf_len {engine.buf_len} and the engine has no "
                    f"sliding window — raise buf_len or serve with "
                    f"window > 0")
        self.queue.append(req)

    @property
    def busy(self):
        return any(r is not None for r in self.table)

    def free_slots(self):
        if self.mode == "static" and self.busy:
            return []
        return [s for s, r in enumerate(self.table) if r is None]


def _sync(engine):
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def serve(engine: SlotEngine, requests, mode: str = "continuous",
          key: int | None = None) -> ServeReport:
    """Serve ``requests`` to completion. Returns per-request outputs plus
    step / occupancy (structural) and wall-clock (timing) metrics."""
    sched = Scheduler(engine.max_slots, mode=mode)
    for r in requests:
        sched.submit(r, engine)

    base_key = key if key is not None else 0
    slots = engine.blank_slots()
    feed = np.zeros((engine.max_slots,), np.int64)
    results = {}
    steps = 0
    active_slot_steps = 0
    _sync(engine)
    t0 = time.perf_counter()

    while sched.queue or sched.busy:
        for s in sched.free_slots():
            if not sched.queue:
                break
            req = sched.queue.popleft()
            state, start = engine.request_state(engine.example)
            state, idx, tail = engine.prefill_chunks(state, req.tokens, start)
            rkey = req.key if req.key is not None else fold_in(base_key,
                                                               req.rid)
            slots = engine.insert(slots, state, s, idx, -(len(tail) - 1),
                                  req.max_new_tokens, rkey)
            sched.table[s] = _SlotRec(req=req, tail=tail, fed=0,
                                      admitted_step=steps)
            feed[s] = tail[0]

        nxt, slots = engine.decode(slots, feed)   # synchronises: nxt on host
        steps += 1
        now = time.perf_counter()
        for s, rec in enumerate(sched.table):
            if rec is None:
                continue
            active_slot_steps += 1
            if rec.fed + 1 < len(rec.tail):
                # still feeding the prompt tail; the sample is a by-product
                rec.fed += 1
                feed[s] = rec.tail[rec.fed]
                continue
            tok = int(nxt[s])
            if not rec.out:
                rec.ttft_s = now - t0
            rec.out.append(tok)
            feed[s] = tok
            if len(rec.out) == rec.req.max_new_tokens:
                results[rec.req.rid] = RequestResult(
                    rid=rec.req.rid, tokens=rec.out, ttft_s=rec.ttft_s,
                    admitted_step=rec.admitted_step, finished_step=steps)
                sched.table[s] = None   # the engine flipped `active` too

    _sync(engine)
    wall = time.perf_counter() - t0
    generated = sum(len(r.tokens) for r in results.values())
    return ServeReport(
        results=results,
        steps=steps,
        generated=generated,
        occupancy=(active_slot_steps / (steps * engine.max_slots)
                   if steps else 0.0),
        wall_s=wall,
        tok_s=generated / wall if wall > 0 else 0.0,
        ttft_mean_s=(sum(r.ttft_s for r in results.values()) / len(results)
                     if results else 0.0),
        mode=mode,
    )


__all__ = ["MODES", "Request", "RequestResult", "Scheduler", "ServeReport",
           "serve"]
