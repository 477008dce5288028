"""Fault-tolerant round supervisor: heartbeat membership, quorum degrade,
and crash-safe checkpoint recovery for the DPPF round loop (counterpart
of ``repro/train/supervisor.py``, with the same policy, event vocabulary
and replay contract).

The ``Supervisor`` owns the host-side round iteration that used to live
inline in ``launch/train.py``: each round it polls a pluggable
``Membership`` provider, drives ``set_participation`` with the resulting
row mask (the ``core/consensus.py`` mask-provider contract), enforces a
quorum policy (below ``quorum`` active rows the round degrades to
local-only steps — the elastic carry's scalar ``sync`` gate skips the
consensus application bit-exactly — with exponential backoff + jitter),
and recovers from round-level failures by restoring the last good
checkpoint and replaying under a retry budget. ``RESOURCE_EXHAUSTED``
failures reuse the ``is_oom`` contract: the per-worker batch shrinks
instead of dying, down the TunePlan's feasible probe batches when one is
given, else by halving.

Membership providers expose ``workers`` and
``mask_for(round) -> (mask, events)``; three ship here:

* ``HeartbeatMembership`` — the in-process heartbeat table: per-worker
  last-beat deadline + miss counter driving the
  ``ACTIVE -> SUSPECT -> DEAD -> REJOINING`` state machine;
* ``ChaosMembership``  — a ``ChaosPlan``'s kill/stall/netdrop windows
  scripted onto that same table over a virtual round clock (one round =
  ``round_s`` seconds), so CI replays are deterministic;
* ``ScheduleMembership`` — the legacy ``--elastic-drop W,A,B`` demo as
  one trivial provider (no events, bit-for-bit the old behavior).

Everything the supervisor does in response to a fault — suspect, evict,
rejoin, recover, degrade, oom, shrink, restore, restore_corrupt, retry —
is appended to ``events`` (and emitted through ``RoundMetricsLogger``
when one is attached), so a run's fault timeline is a structured,
replayable artifact. Determinism contract: no wall clocks and no global
RNG — backoff jitter is a sha256 of ``(seed, round, attempt)``, recorded
in the event and only actually slept when a ``sleep_fn`` is provided
(CI runs on virtual time).

On a mesh of ``torch.distributed`` ranks (``mesh`` / ``plan``) every rank
runs the same supervisor: membership, chaos and jitter are pure functions
of the plan and the seed, so they agree by construction, and whether a
round failed is agreed through an all-reduce of a flag before the retry
decision. A real fault on one rank fails the round on every rank where
it is raised outside the step (the chaos hook, the batch) or in the
step's local steps, which the sharded step holds and agrees on before
the boundary's collectives (``trainer._agree_local_steps``). A fault
inside a collective, or a rank that dies, leaves the others waiting in
that collective until the process group's timeout (``launch.mesh.start``,
600 s by default) ends the run in an error. The rotation checkpoint is
one file, gathered leaf by leaf and written by rank 0
(``checkpoint.save_train_state``); only that rank tears it under a
``corrupt_ckpt`` event, and every rank restores its own blocks from the
same file.

The round step updates the state in place, so after a failed step the
state is dropped and recovery goes through the checkpoint alone (as the
reference's donated buffers force it to). The restore template holds only
the (shard's) shapes and dtypes (``trainer.state_template``), not a host
copy of the state; after an OOM the caching allocator's blocks are released
before the replay.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from repro_torch.checkpoint import load_train_state, save_train_state
from repro_torch.optim.optimizers import leaves
from repro_torch.train.autotune import is_oom
from repro_torch.train.trainer import set_participation, state_template

ACTIVE = "active"
SUSPECT = "suspect"
DEAD = "dead"
REJOINING = "rejoining"


class HeartbeatMembership:
    """In-process heartbeat table. ``beat(w, now)`` records a worker's
    heartbeat; ``poll(now)`` advances every worker's state machine and
    returns the participation mask. A worker whose last beat is older
    than ``timeout`` seconds accrues one missed poll; ``suspect_after``
    consecutive misses demote ACTIVE -> SUSPECT, ``dead_after`` misses
    SUSPECT -> DEAD (evicted from the mask). The first beat after DEAD
    re-admits the row as REJOINING (it is back in the mask — the elastic
    catch-up pull does the state repair) and the next beat completes
    REJOINING -> ACTIVE; a beat during SUSPECT recovers straight to
    ACTIVE. All guards are ValueError, never assert (python -O)."""

    def __init__(self, workers: int, *, timeout: float,
                 suspect_after: int = 1, dead_after: int = 2,
                 start_time: float = 0.0):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if not timeout > 0:
            raise ValueError(
                f"heartbeat timeout must be > 0 seconds, got {timeout}")
        if not 1 <= suspect_after <= dead_after:
            raise ValueError(
                f"need 1 <= suspect_after ({suspect_after}) <= "
                f"dead_after ({dead_after})")
        self.workers = workers
        self.timeout = float(timeout)
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.state = [ACTIVE] * workers
        self.last_beat = [float(start_time)] * workers
        self.missed = [0] * workers

    def beat(self, worker: int, now: float):
        """One heartbeat. Returns the transitions it caused as
        ``(worker, from_state, to_state)`` tuples."""
        if not 0 <= worker < self.workers:
            raise ValueError(f"worker {worker} out of range "
                             f"[0, {self.workers})")
        out = []
        s = self.state[worker]
        if s == DEAD:
            self.state[worker] = REJOINING
            out.append((worker, DEAD, REJOINING))
        elif s in (SUSPECT, REJOINING):
            self.state[worker] = ACTIVE
            out.append((worker, s, ACTIVE))
        self.last_beat[worker] = float(now)
        self.missed[worker] = 0
        return out

    def poll(self, now: float):
        """Advance deadlines and return ``(mask, transitions)`` — mask is
        the (workers,) float32 participation vector (ACTIVE and REJOINING
        rows are in; SUSPECT and DEAD rows are out)."""
        out = []
        for w in range(self.workers):
            if float(now) - self.last_beat[w] > self.timeout:
                self.missed[w] += 1
                s = self.state[w]
                if s in (ACTIVE, REJOINING) \
                        and self.missed[w] >= self.suspect_after:
                    self.state[w] = SUSPECT
                    out.append((w, s, SUSPECT))
                if self.state[w] == SUSPECT \
                        and self.missed[w] >= self.dead_after:
                    self.state[w] = DEAD
                    out.append((w, SUSPECT, DEAD))
        mask = np.asarray(
            [1.0 if s in (ACTIVE, REJOINING) else 0.0
             for s in self.state], np.float32)
        return mask, out


# transition -> recovery-event name (the structured-event vocabulary)
_EVENT_OF = {SUSPECT: "suspect", DEAD: "evict", REJOINING: "rejoin",
             ACTIVE: "recover"}


class ChaosMembership:
    """A ``ChaosPlan``'s kill/stall/netdrop windows driving a
    ``HeartbeatMembership`` table over a virtual round clock: workers not
    inside a down-window beat at ``round * round_s``; the poll runs at
    the same instant, so a worker that has been silent for a full round
    misses its deadline iff ``timeout < round_s``. Pure plan state — a
    replay walks the identical transition sequence."""

    def __init__(self, plan, workers: int, *, timeout: float,
                 round_s: float = 1.0, suspect_after: int = 1,
                 dead_after: int = 2):
        if not round_s > 0:
            raise ValueError(f"round_s must be > 0, got {round_s}")
        self.plan = plan
        self.workers = workers
        self.round_s = float(round_s)
        # everyone "beat" just before round 0, so a round-0 down-window
        # is one full round of silence at the first poll
        self.table = HeartbeatMembership(
            workers, timeout=timeout, suspect_after=suspect_after,
            dead_after=dead_after, start_time=-round_s)
        self._next = 0

    def mask_for(self, round_idx: int):
        if round_idx != self._next:
            raise ValueError(
                f"ChaosMembership.mask_for must advance one round at a "
                f"time (asked {round_idx}, expected {self._next}) — the "
                "supervisor caches replayed rounds")
        self._next += 1
        now = round_idx * self.round_s
        transitions = []
        for w in range(self.workers):
            if not self.plan.is_down(w, round_idx):
                transitions.extend(self.table.beat(w, now))
        mask, polled = self.table.poll(now)
        transitions.extend(polled)
        events = [{"event": _EVENT_OF[to], "worker": w, "from": frm}
                  for (w, frm, to) in transitions]
        return mask, events


class ScheduleMembership:
    """The ``--elastic-drop W,A,B`` demo schedule as a membership
    provider: worker W is out of the mask for rounds [A, B). Emits no
    events (a requested drop is not a fault) — the supervisor-driven loop
    stays bit-for-bit the old inline loop."""

    def __init__(self, workers: int, drops):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.workers = workers
        self.drops = []
        for (w, a, b) in drops:
            if not 0 <= w < workers:
                raise ValueError(
                    f"drop worker {w} out of range [0, {workers})")
            if not 0 <= a < b:
                raise ValueError(
                    f"drop window [{a}, {b}) is empty or negative — "
                    "need 0 <= A < B")
            self.drops.append((int(w), int(a), int(b)))

    def mask_for(self, round_idx: int):
        mask = np.ones((self.workers,), np.float32)
        for (w, a, b) in self.drops:
            if a <= round_idx < b:
                mask[w] = 0.0
        return mask, []


def _jitter01(seed: int, round_idx: int, attempt: int) -> float:
    """Deterministic uniform in [0, 1) — sha256 of the (seed, round,
    attempt) triple, the tests/_faults.py noisy_time_fn idiom."""
    h = hashlib.sha256(
        f"{seed}:{round_idx}:{attempt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class Supervisor:
    """Host-side fault-tolerant round loop. See the module docstring for
    the policy; ``run`` is the entry point.

    Parameters (ValueError on bad values — python -O safe):

    * ``clock``        — the run's RoundClock (owns the round specs);
    * ``workers``      — worker-row count (the mask provider contract);
    * ``membership``   — optional provider with ``mask_for(round)``;
      when None the loop never touches participation (non-elastic runs);
    * ``quorum``       — min active rows for a consensus round; below it
      the round degrades to local-only steps (``sync=0``). 0 disables;
    * ``retry_budget`` — max CONSECUTIVE failed rounds before the
      original exception propagates;
    * ``chaos``        — optional ``FaultInjector`` (scripted faults);
    * ``ckpt_dir``     — rotation-checkpoint directory (``sup_last.npz``
      / ``sup_prev.npz``); empty string disables restore (failures then
      propagate immediately);
    * ``tune_plan``    — optional TunePlan whose feasible probe batches
      form the OOM shrink ladder;
    * ``batch_size``   — per-worker batch, threaded to ``batch_fn`` and
      shrunk on OOM;
    * ``logger``       — optional RoundMetricsLogger; recovery events are
      emitted as rows with an ``"event"`` key;
    * ``on_round``     — optional ``f(spec, metrics)`` called after every
      successful round (progress printing);
    * ``mesh`` / ``plan`` — the state is this rank's shard on a mesh of
      ranks: checkpoints are gathered and written by rank 0, each rank
      restores its own blocks, failures are agreed over the world;
    * ``sleep_fn``     — when given, called with the backoff seconds
      (production); None = virtual time (CI replay determinism).
    """

    def __init__(self, clock, *, workers: int, membership=None,
                 quorum: int = 0, retry_budget: int = 3, chaos=None,
                 ckpt_dir: str = "", ckpt_every: int = 1, tune_plan=None,
                 batch_size: int = 0, logger=None, on_round=None,
                 mesh=None, plan=None, sleep_fn=None,
                 seed: int = 0, backoff_base: float = 0.5,
                 backoff_cap: float = 30.0):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if quorum < 0:
            raise ValueError(f"quorum must be >= 0, got {quorum}")
        if quorum > workers:
            raise ValueError(
                f"quorum {quorum} exceeds the worker count {workers} — "
                "no round could ever reach it")
        if retry_budget < 0:
            raise ValueError(
                f"retry_budget must be >= 0, got {retry_budget}")
        if ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
        if not backoff_base > 0:
            raise ValueError(
                f"backoff_base must be > 0, got {backoff_base}")
        if membership is not None \
                and getattr(membership, "workers", workers) != workers:
            raise ValueError(
                f"membership provider covers "
                f"{membership.workers} workers, supervisor drives "
                f"{workers}")
        self.clock = clock
        self.workers = workers
        self.membership = membership
        self.quorum = quorum
        self.retry_budget = retry_budget
        self.chaos = chaos
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.tune_plan = tune_plan
        self.batch_size = int(batch_size)
        self.logger = logger
        self.on_round = on_round
        self.mesh, self.plan = mesh, plan
        self.writer = mesh is None or mesh.rank == 0
        self._device = None
        self.sleep_fn = sleep_fn
        self.seed = seed
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.events = []
        self.counters = {}
        self._mask_cache = {}
        self._degrade_streak = 0

    # -- events --------------------------------------------------------------

    def _emit(self, round_idx, event, *, worker=None, detail="",
              backoff_s=None, attempt=None):
        ev = {"round": int(round_idx), "event": str(event)}
        if worker is not None:
            ev["worker"] = int(worker)
        if detail:
            ev["detail"] = str(detail)
        if backoff_s is not None:
            ev["backoff_s"] = round(float(backoff_s), 3)
        if attempt is not None:
            ev["attempt"] = int(attempt)
        self.events.append(ev)
        self.counters[ev["event"]] = self.counters.get(ev["event"], 0) + 1
        if self.logger is not None:
            self.logger(int(round_idx),
                        {k: v for k, v in ev.items() if k != "round"})

    def event_seq(self):
        """The compact replay-pinned form: ``r<round>:<event>[:w<worker>]``
        strings in emission order."""
        return [f"r{e['round']}:{e['event']}"
                + (f":w{e['worker']}" if "worker" in e else "")
                for e in self.events]

    def summary(self):
        return {"counters": dict(sorted(self.counters.items())),
                "event_seq": self.event_seq(),
                "final_batch": self.batch_size}

    # -- membership ----------------------------------------------------------

    def _mask(self, round_idx):
        """Provider poll with a per-round cache: a round re-executed after
        a restore re-uses its original mask and does NOT re-emit its
        membership events (the fault timeline stays bit-identical across
        replays)."""
        if round_idx in self._mask_cache:
            return self._mask_cache[round_idx]
        mask, events = self.membership.mask_for(round_idx)
        mask = np.asarray(mask, np.float32)
        for e in events:
            self._emit(round_idx, e["event"], worker=e.get("worker"),
                       detail=e.get("from", ""))
        self._mask_cache[round_idx] = mask
        return mask

    # -- checkpoint rotation + restore ladder --------------------------------

    def _ckpt_paths(self):
        return (os.path.join(self.ckpt_dir, "sup_last.npz"),
                os.path.join(self.ckpt_dir, "sup_prev.npz"))

    def _save(self, state, round_idx):
        last, prev = self._ckpt_paths()
        if self.writer and os.path.exists(last):
            os.replace(last, prev)
        # atomic (checkpoint/io.py); on a mesh rank 0 writes and all wait
        save_train_state(last, state, mesh=self.mesh, plan=self.plan)
        self.counters["ckpt_saved"] = self.counters.get("ckpt_saved", 0) + 1
        if self.writer and self.chaos is not None \
                and self.chaos.after_save(round_idx, last):
            # the fault itself is scripted, not a recovery action — the
            # restore ladder's detection emits restore_corrupt later
            pass
        self._barrier()

    def _barrier(self):
        if self.mesh is not None and torch.distributed.is_initialized():
            torch.distributed.barrier()

    def _agree(self, err):
        """``(failed, oom)`` of this round over every rank: a failure on
        one rank fails the round on all of them (they would otherwise hang
        in the next collective)."""
        failed, oom = err is not None, err is not None and is_oom(err)
        if self.mesh is None or not torch.distributed.is_initialized() \
                or torch.distributed.get_world_size() == 1:
            return failed, oom
        dev = self._device if torch.distributed.get_backend() == "nccl" \
            else "cpu"
        flag = torch.tensor([float(failed), float(oom)], device=dev)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag[0] > 0), bool(flag[1] > 0)

    def _restore(self, failed_round, like):
        """The restore ladder: newest rotation copy first, the corrupt-
        archive ValueError from checkpoint/io.py drops to the next rung."""
        last, prev = self._ckpt_paths()
        for path, tag in ((last, "last"), (prev, "prev")):
            if not os.path.exists(path):
                continue
            try:
                st = load_train_state(path, like, clock=self.clock,
                                      device=self._device, mesh=self.mesh,
                                      plan=self.plan)
            except ValueError as e:
                self._emit(failed_round, "restore_corrupt",
                           detail=f"{tag}: {str(e)[:100]}")
                continue
            rnd = int(st.round)
            self._emit(failed_round, "restore",
                       detail=f"{tag} (round {rnd})")
            return st, rnd
        raise RuntimeError(
            f"supervisor: no recoverable checkpoint in {self.ckpt_dir!r} "
            f"after round {failed_round} failed (both rotation copies "
            "missing or corrupt)")

    # -- OOM shrink ladder ---------------------------------------------------

    def _shrunk_batch(self):
        """Next smaller feasible per-worker batch: the TunePlan's ok-probe
        ladder below the current size when a plan is given, else halving.
        Returns None when there is nothing smaller to try."""
        cur = self.batch_size
        if self.tune_plan is not None:
            ok = sorted({p.batch for p in self.tune_plan.probes
                         if p.ok and p.batch < cur})
            if ok:
                return ok[-1]
        half = cur // 2
        return half if half >= 1 else None

    def _backoff(self, round_idx, attempt):
        base = min(self.backoff_cap,
                   self.backoff_base * (2.0 ** max(0, attempt - 1)))
        return base * (0.5 + _jitter01(self.seed, round_idx, attempt))

    # -- the loop ------------------------------------------------------------

    def run(self, state, step_fn, batch_fn, *, start_round: int = 0,
            end_round=None):
        """Drive rounds ``start_round .. len(clock.rounds)`` to completion
        (or to ``end_round``, exclusive: a run cut short on purpose).

        ``step_fn(state, batch) -> (state, metrics)`` is the round step
        (in place); ``batch_fn(spec, batch_size) -> batch`` builds the
        round's batch. Returns the final state. Failure policy: any
        exception from the step is retried (restore + replay) up to
        ``retry_budget`` consecutive times when a ``ckpt_dir`` is set —
        OOMs additionally shrink the batch first — after which the
        original exception propagates. A failed step may have written
        part of the state in place, which is why recovery always goes
        through the checkpoint restore, never by re-using the pre-step
        state object."""
        rounds = self.clock.rounds
        like = None
        self._device = leaves(state.params)[0].device
        if self.ckpt_dir:
            if self.writer:
                os.makedirs(self.ckpt_dir, exist_ok=True)
            # the restore template: the (shard's) shapes and dtypes
            like = state_template(state)
            self._save(state, start_round - 1)
        i = start_round
        consec_fail = 0
        stop = len(rounds) if end_round is None \
            else min(len(rounds), end_round)
        while i < stop:
            spec = rounds[i]
            sync = 1.0
            if self.membership is not None:
                mask = self._mask(spec.index)
                n_active = int(mask.sum())
                if self.quorum and n_active < self.quorum:
                    # below quorum: the round degrades to local-only
                    # steps (sync=0 skips the consensus application
                    # bit-exactly) and the NEXT consensus attempt backs
                    # off exponentially with deterministic jitter —
                    # progress continues, the fleet never spins
                    self._degrade_streak += 1
                    sync = 0.0
                    b = self._backoff(spec.index, self._degrade_streak)
                    self._emit(spec.index, "degrade",
                               detail=f"active {n_active} < quorum "
                                      f"{self.quorum}",
                               backoff_s=b, attempt=self._degrade_streak)
                    if self.sleep_fn is not None:
                        self.sleep_fn(b)
                else:
                    self._degrade_streak = 0
                state = set_participation(state, mask, sync=sync)
            err = None
            try:
                if self.chaos is not None:
                    self.chaos.before_step(spec.index, self.batch_size)
                batch = batch_fn(spec, self.batch_size)
            except Exception as e:   # noqa: BLE001 — policy: retry w/ budget
                err = e
            # on a mesh no rank enters the step's collectives alone
            if self._agree(err)[0] and err is None:
                err = RuntimeError(f"supervisor: round {spec.index} failed "
                                   "on another rank before its step")
            if err is None:
                try:
                    state, metrics = step_fn(state, batch)
                except Exception as e:   # noqa: BLE001 — as above
                    err = e
            failed, oom = self._agree(err)
            if failed:
                e = err if err is not None else RuntimeError(
                    f"supervisor: round {spec.index} failed on another "
                    "rank")
                consec_fail += 1
                if oom:
                    self._emit(spec.index, "oom", detail=str(e)[:120])
                if like is None or consec_fail > self.retry_budget:
                    raise e
                # the step wrote in place: drop the state, and after an
                # OOM the allocator's cached blocks, before the restore
                state = batch = None
                if oom and torch.cuda.is_available():
                    torch.cuda.empty_cache()
                if oom:
                    smaller = self._shrunk_batch()
                    if smaller is None:
                        raise e
                    self._emit(spec.index, "shrink",
                               detail=f"batch {self.batch_size} -> "
                                      f"{smaller}")
                    self.batch_size = smaller
                state, restored = self._restore(spec.index, like)
                b = self._backoff(spec.index, consec_fail)
                self._emit(spec.index, "retry",
                           detail=f"replay from round {restored}",
                           backoff_s=b, attempt=consec_fail)
                if self.sleep_fn is not None:
                    self.sleep_fn(b)
                i = restored
                continue
            consec_fail = 0
            if self.on_round is not None:
                self.on_round(spec, metrics)
            if self.logger is not None:
                self.logger(spec, metrics)
            if self.ckpt_dir and (spec.index + 1) % self.ckpt_every == 0:
                self._save(state, spec.index)
            i += 1
        return state
