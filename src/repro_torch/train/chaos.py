"""Replayable chaos injection for the fault-tolerant round supervisor
(counterpart of ``repro/train/chaos.py``; a plan's JSON is byte-identical
in both packages, so one plan file replays in either).

A ``ChaosPlan`` is the fault analog of the autotuner's ``TunePlan``: a
byte-stable JSON artifact scripting per-round fault events, so the SAME
faults replay bit-identically in CI and the pinned recovery-event sequence
is a committed contract, not a flaky observation. Event kinds:

* ``kill``         — worker ``w`` stops heartbeating for ``duration``
                     rounds (process death; rejoins after the window);
* ``stall``        — straggler: same heartbeat silence, conventionally a
                     short window (the worker is late, not gone);
* ``netdrop``      — partition: heartbeats lost in transit, same observable
                     effect on the membership table as a kill;
* ``oom``          — the training step raises ``RESOURCE_EXHAUSTED`` at
                     this round while the per-worker batch exceeds
                     ``batch_above`` (the ``is_oom`` contract — the
                     supervisor shrinks the batch and replays);
* ``corrupt_ckpt`` — the checkpoint written at this round is torn after
                     the (atomic) save, exercising the restore ladder's
                     corrupt-archive fallback.

The first three only differ in intent; the membership table sees missed
heartbeats either way and walks the same ACTIVE -> SUSPECT -> DEAD ->
REJOINING machine. ``FaultInjector`` is the trainer-boundary hook set
(``before_step`` / ``after_save``) the supervisor calls; it is pure state
read from the plan — no clocks, no randomness — so a replay of the same
plan takes the same branches.

``InjectedOOM`` lives here so that every user of the OOM-matching
message contract takes it from one place.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Tuple

from repro_torch.train.autotune import is_oom  # noqa: F401  (re-export:
#   the supervisor and the fault tests import the OOM contract from ONE
#   place)

PLAN_VERSION = 1

KINDS = ("kill", "stall", "oom", "corrupt_ckpt", "netdrop")
# kinds observable as missed heartbeats (drive the membership table)
MEMBERSHIP_KINDS = ("kill", "stall", "netdrop")


class InjectedOOM(RuntimeError):
    """Scripted allocator failure. A plain RuntimeError whose message
    carries the ``RESOURCE_EXHAUSTED`` token, so ``is_oom`` (the message
    contract) recognizes it."""

    def __init__(self, batch, round_idx=None):
        where = f" (round {round_idx})" if round_idx is not None else ""
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected OOM at batch={batch}{where}")
        self.batch = batch
        self.round_idx = round_idx


@dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault. ``worker`` is required (>= 0) for the
    membership kinds; ``batch_above`` is required (>= 1) for ``oom`` —
    the fault clears once the supervisor has shrunk the per-worker batch
    to ``batch_above`` or below, which is what makes the OOM recoverable
    rather than a death loop."""
    round: int
    kind: str
    worker: int = -1
    duration: int = 1
    batch_above: int = 0

    def __post_init__(self):
        # ValueError, never assert: plans are user-authored JSON and the
        # guards must survive python -O (tests/optcheck.py)
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown chaos kind {self.kind!r} (one of {KINDS})")
        if self.round < 0:
            raise ValueError(f"event round must be >= 0, got {self.round}")
        if self.duration < 1:
            raise ValueError(
                f"event duration must be >= 1, got {self.duration}")
        if self.kind in MEMBERSHIP_KINDS and self.worker < 0:
            raise ValueError(
                f"{self.kind} event needs a worker index >= 0")
        if self.kind == "oom" and self.batch_above < 1:
            raise ValueError(
                "oom event needs batch_above >= 1 (the per-worker batch "
                "size at which the injected allocator stops failing)")

    def to_dict(self) -> dict:
        d = {"round": self.round, "kind": self.kind}
        if self.kind in MEMBERSHIP_KINDS:
            d["worker"] = self.worker
            d["duration"] = self.duration
        if self.kind == "oom":
            d["batch_above"] = self.batch_above
        return d


@dataclass(frozen=True)
class ChaosPlan:
    """The replayable fault script. Same serialization idiom as TunePlan:
    ``to_dict`` emits canonically ordered, source-rounded JSON so a
    load -> save round-trip is byte-identical; ``from_dict`` wraps any
    payload shape error in one clear ValueError. ``seed`` feeds the
    supervisor's deterministic backoff jitter."""
    events: Tuple[ChaosEvent, ...] = ()
    seed: int = 0
    version: int = PLAN_VERSION

    def __post_init__(self):
        if self.version != PLAN_VERSION:
            raise ValueError(f"ChaosPlan version {self.version} != "
                             f"{PLAN_VERSION} (re-author the plan)")
        # canonical event order — makes dumps() independent of authoring
        # order and the replayed injection order well-defined
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events,
                         key=lambda e: (e.round, e.kind, e.worker))))

    # -- queries -------------------------------------------------------------

    def membership_events(self) -> Tuple[ChaosEvent, ...]:
        return tuple(e for e in self.events
                     if e.kind in MEMBERSHIP_KINDS)

    def is_down(self, worker: int, round_idx: int) -> bool:
        """Is this worker's heartbeat silenced at this round?"""
        return any(e.worker == worker
                   and e.round <= round_idx < e.round + e.duration
                   for e in self.membership_events())

    # -- deterministic JSON --------------------------------------------------

    def to_dict(self) -> dict:
        return {"version": self.version, "seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "ChaosPlan":
        try:
            events = tuple(
                ChaosEvent(round=int(e["round"]), kind=str(e["kind"]),
                           worker=int(e.get("worker", -1)),
                           duration=int(e.get("duration", 1)),
                           batch_above=int(e.get("batch_above", 0)))
                for e in d["events"])
            return cls(events=events, seed=int(d.get("seed", 0)),
                       version=int(d.get("version", -1)))
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed ChaosPlan payload: {e!r}") from e

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path: str) -> "ChaosPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))


class FaultInjector:
    """Trainer-boundary chaos hooks. The supervisor calls ``before_step``
    ahead of every round's step and ``after_save`` after every checkpoint
    write; both are pure functions of (plan, round, argument) so the same
    plan replays to the same faults — including on the re-executed rounds
    after a restore (an oom event keeps firing until the batch is small
    enough; a corrupt_ckpt event re-tears the re-written file)."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan

    def before_step(self, round_idx: int, batch: int) -> None:
        """Raise InjectedOOM when an oom event covers this round and the
        per-worker batch is still above its clearing threshold."""
        for e in self.plan.events:
            if e.kind == "oom" and e.round == round_idx \
                    and batch > e.batch_above:
                raise InjectedOOM(batch, round_idx=round_idx)

    def after_save(self, round_idx: int, path: str) -> bool:
        """Tear the just-written checkpoint (truncate to half its bytes —
        an un-openable zip) when a corrupt_ckpt event covers this round.
        Returns True when the file was corrupted."""
        for e in self.plan.events:
            if e.kind == "corrupt_ckpt" and e.round == round_idx:
                with open(path, "rb") as f:
                    data = f.read()
                with open(path, "wb") as f:
                    f.write(data[:max(1, len(data) // 2)])
                return True
        return False
