"""RoundClock: the single source of truth for step/round accounting.

Counterpart of ``repro/train/clock.py``. The clock precomputes the whole
round plan on the host — a tuple of ``RoundSpec(index, start, tau)``
covering every one of ``total_steps`` steps (the final round absorbs the
remainder; with ``tau_schedule="qsr"`` each round's tau comes from the
cosine LR at the round's first step) — and owns the schedule reads:

* ``lam_at(round_idx)``: lam_t for the round ABOUT TO RUN, evaluated over
  ``total_rounds - 1`` so round 0 sees ``lam_schedule(·, 0, ·)`` and the
  final round the full ``lam``;
* ``lr_at(t)``: the cosine LR at global step ``t``;
* ``pull_scale_at(round_idx)``: the inner/outer plan's pull scale.

PyTorch runs eagerly, so all three return python floats. ``describe()``
and ``plan_table()`` render the plan (the reference's dry-run report and
committed round-clock baseline), string for string as the reference does.
``RoundMetricsLogger`` writes the reference's per-round JSONL record.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

from repro_torch.core.schedules import cosine_lr, lam_schedule, qsr_tau

TAU_SCHEDULES = ("fixed", "qsr")
OVERLAP_MODES = ("none", "staleness1", "doublebuf", "staleness_k")


@dataclass(frozen=True)
class RoundSpec:
    """One communication round of the plan (host ints, known up front)."""
    index: int      # 0-based round index
    start: int      # GLOBAL step of the round's first local step
    tau: int        # local steps this round (the last may be shorter)
    scope: str = "outer"   # "inner" sub-rounds apply the weak pull

    @property
    def stop(self) -> int:
        """Global step after the round (== next round's ``start``)."""
        return self.start + self.tau


def _host_cosine_lr(base_lr: float, t: int, total: int, warmup: int) -> float:
    """Float64 cosine LR for the host-side QSR plan (the reference's
    ``_host_cosine_lr``)."""
    if t < warmup:
        return base_lr * t / max(warmup, 1)
    frac = min(max((t - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr / 2.0 * (1.0 + math.cos(frac * math.pi))


@dataclass(frozen=True)
class RoundClock:
    """Step/round accounting for one training run (hashable, host-side)."""
    total_steps: int
    tau: int                         # base communication period
    base_lr: float = 0.0
    warmup: int = 0
    lam: float = 0.0
    lam_kind: str = "increasing"     # fixed | increasing | decreasing (§C.2)
    tau_schedule: str = "fixed"      # fixed | qsr (§7.2)
    qsr_beta: float = 0.0
    overlap: str = "none"
    staleness: int = 1
    inner_rounds: int = 0
    inner_pull: float = 1.0

    def __post_init__(self):
        if self.total_steps < 1:
            raise ValueError(f"total_steps must be >= 1, got {self.total_steps}")
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        if self.tau_schedule not in TAU_SCHEDULES:
            raise ValueError(f"unknown tau schedule {self.tau_schedule!r} "
                             f"(expected one of {TAU_SCHEDULES})")
        if self.tau_schedule == "qsr":
            if self.qsr_beta <= 0:
                raise ValueError("tau_schedule='qsr' needs qsr_beta > 0")
            if self.base_lr <= 0:
                raise ValueError("tau_schedule='qsr' adapts tau to the "
                                 "cosine LR and needs base_lr > 0")
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(f"unknown overlap mode {self.overlap!r} "
                             f"(expected one of {OVERLAP_MODES})")
        if self.warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {self.warmup}")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {self.staleness}")
        if self.inner_rounds < 0:
            raise ValueError(f"inner_rounds must be >= 0, got "
                             f"{self.inner_rounds}")
        if not 0.0 < self.inner_pull <= 1.0:
            raise ValueError(f"inner_pull must be in (0, 1], got "
                             f"{self.inner_pull}")
        if self.overlap == "staleness_k" and self.warmup > 0 and \
                math.ceil(self.warmup / self.tau) < self.staleness:
            raise ValueError(
                f"overlap='staleness_k' needs warmup >= k rounds so the "
                f"pipeline fill never straddles the warmup boundary: "
                f"warmup={self.warmup} steps covers "
                f"{math.ceil(self.warmup / self.tau)} rounds at tau="
                f"{self.tau} but staleness k={self.staleness} (use "
                f"warmup=0 or warmup >= {self.staleness * self.tau})")

    @classmethod
    def from_config(cls, dcfg, *, base_lr: float, total_steps: int,
                    warmup: int = 0) -> "RoundClock":
        """Build the clock from a ``DPPFConfig`` + the LR triple. A config
        with ``qsr_beta > 0`` opts into QSR even if ``tau_schedule`` was
        left at "fixed"."""
        tau_schedule = dcfg.tau_schedule
        if tau_schedule == "fixed" and dcfg.qsr_beta > 0:
            tau_schedule = "qsr"
        from repro_torch.core.methods import get_method
        spec = get_method(dcfg.consensus)
        return cls(total_steps=total_steps, tau=dcfg.tau, base_lr=base_lr,
                   warmup=warmup, lam=dcfg.lam, lam_kind=dcfg.lam_schedule,
                   tau_schedule=tau_schedule, qsr_beta=dcfg.qsr_beta,
                   overlap=dcfg.overlap, staleness=dcfg.staleness,
                   inner_rounds=spec.inner_rounds,
                   inner_pull=spec.inner_pull)

    @classmethod
    def from_tune_plan(cls, plan, *, base_lr: float, total_steps: int,
                       warmup: int = 0, dcfg=None) -> "RoundClock":
        """Build the clock from an autotune ``TunePlan`` (the
        ``--autotune`` / ``--tune-plan`` path), the dataclass or its
        ``to_dict()`` form. The plan pins tau with ``tau_schedule="fixed"``.
        With ``dcfg`` the plan goes onto the config
        (``dcfg.apply_tune_plan``) and through ``from_config``, keeping lam
        and the method's inner / outer plan; without, a bare fixed-tau
        clock."""
        if isinstance(plan, dict):
            tau = int(plan["chosen"]["tau"])
            overlap = str(plan.get("overlap", "none"))
            staleness = int(plan.get("staleness", 1))
        else:
            tau = int(plan.chosen.tau)
            overlap = plan.overlap
            staleness = int(plan.staleness)
        if dcfg is not None:
            return cls.from_config(dcfg.apply_tune_plan(plan),
                                   base_lr=base_lr, total_steps=total_steps,
                                   warmup=warmup)
        return cls(total_steps=total_steps, tau=tau, base_lr=base_lr,
                   warmup=warmup, tau_schedule="fixed", overlap=overlap,
                   staleness=staleness)

    @property
    def staleness_depth(self) -> int:
        """Pipeline depth of the overlap mode: 0, 1 or k."""
        if self.overlap == "none":
            return 0
        if self.overlap == "staleness_k":
            return self.staleness
        return 1

    # -- round plan ---------------------------------------------------------

    @cached_property
    def rounds(self) -> Tuple[RoundSpec, ...]:
        rounds, t = [], 0
        while t < self.total_steps:
            if self.tau_schedule == "qsr":
                if t < self.warmup:
                    # warmup rounds keep the base tau and never straddle
                    # the warmup boundary
                    tau_t = min(self.tau, self.warmup - t)
                else:
                    # overlap-aware QSR: the period of round r is ruled by
                    # the LR of the round-(r-k) start (the stale LR)
                    t_lr = t
                    d = self.staleness_depth
                    if d >= 1 and len(rounds) >= d and \
                            rounds[-d].start >= self.warmup:
                        t_lr = rounds[-d].start
                    eta = _host_cosine_lr(self.base_lr, t_lr,
                                          self.total_steps, self.warmup)
                    tau_t = qsr_tau(eta, self.tau, self.qsr_beta)
            else:
                tau_t = self.tau
            tau_t = min(tau_t, self.total_steps - t)   # never drop remainder
            for piece, scope in self._split_inner(tau_t):
                rounds.append(RoundSpec(index=len(rounds), start=t,
                                        tau=piece, scope=scope))
                t += piece
        return tuple(rounds)

    def _split_inner(self, tau_t: int):
        """Split one base round's tau into ``inner_rounds`` near-equal
        pieces, all but the last "inner" (weak pull)."""
        k = self.inner_rounds
        if k <= 1 or tau_t <= 1:
            return [(tau_t, "outer")]
        k = min(k, tau_t)
        base, rem = divmod(tau_t, k)
        pieces = [base + 1] * rem + [base] * (k - rem)
        return [(p, "inner" if i < len(pieces) - 1 else "outer")
                for i, p in enumerate(pieces)]

    @property
    def total_rounds(self) -> int:
        return len(self.rounds)

    def taus(self) -> Tuple[int, ...]:
        return tuple(spec.tau for spec in self.rounds)

    @property
    def fixed_rounds(self) -> int:
        """Rounds a fixed-tau clock would pay for the same step budget."""
        return math.ceil(self.total_steps / self.tau)

    def round_of_step(self, t: int) -> int:
        """Round index containing global step ``t`` (``total_rounds`` when
        ``t == total_steps``)."""
        if t < 0 or t > self.total_steps:
            raise ValueError(f"step {t} outside [0, {self.total_steps}]")
        for spec in self.rounds:
            if t < spec.stop:
                return spec.index
        return self.total_rounds

    # -- schedule reads -------------------------------------------------------

    def lam_at(self, round_idx) -> float:
        """Push strength for round ``round_idx`` (the round ABOUT TO RUN).
        A single-round plan applies the FULL lam."""
        if self.total_rounds == 1:
            return lam_schedule("fixed", self.lam, round_idx, 1)
        return lam_schedule(self.lam_kind, self.lam, round_idx,
                            self.total_rounds - 1)

    def lr_at(self, t) -> float:
        """Cosine LR at global step ``t``."""
        return cosine_lr(self.base_lr, t, self.total_steps, self.warmup)

    def pull_scale_at(self, round_idx) -> float:
        """``inner_pull`` on "inner" sub-rounds, 1.0 on "outer" rounds."""
        if self.inner_rounds <= 1:
            return 1.0
        i = min(max(int(round_idx), 0), self.total_rounds - 1)
        return self.inner_pull if self.rounds[i].scope == "inner" else 1.0

    # -- the plan as a report ------------------------------------------------

    def _host_lam(self, round_idx: int) -> float:
        """Float64 lam_t of the plan report (the reference's
        ``_host_lam``)."""
        T = max(self.total_rounds - 1, 1)
        if self.total_rounds == 1:
            return self.lam
        frac = min(max(round_idx / T, 0.0), 1.0)
        if self.lam_kind == "fixed":
            return self.lam
        if self.lam_kind == "decreasing":
            return self.lam / 2.0 * (1.0 + math.cos(frac * math.pi))
        if self.lam_kind == "increasing":
            return self.lam / 2.0 * (1.0 - math.cos(frac * math.pi))
        raise ValueError(self.lam_kind)

    def describe(self) -> dict:
        """Machine-readable summary + full round plan: one row per round
        with its index, global start step, tau, the lam it applies and the
        LR window ``[lr_start, lr_end]`` its local steps sweep (floats
        rounded to 6 digits)."""
        taus = self.taus()
        depth = self.staleness_depth
        inner = self.inner_rounds > 1
        plan = []
        for spec in self.rounds:
            row = {
                "round": spec.index,
                "start": spec.start,
                "tau": spec.tau,
                "lam": round(self._host_lam(spec.index), 6),
                "lr_start": round(_host_cosine_lr(
                    self.base_lr, spec.start, self.total_steps,
                    self.warmup), 6),
                "lr_end": round(_host_cosine_lr(
                    self.base_lr, spec.stop - 1, self.total_steps,
                    self.warmup), 6),
                "warmup": spec.start < self.warmup,
                # rounds 0..depth-1 apply an exact consensus (0), later
                # rounds the round-(r-depth) snapshot's (depth)
                "staleness": depth if spec.index >= depth else 0,
            }
            if inner:
                # plans without an inner loop keep the legacy row schema
                row["scope"] = spec.scope
            plan.append(row)
        out = {
            "total_steps": self.total_steps,
            "tau_base": self.tau,
            "tau_schedule": self.tau_schedule,
            "qsr_beta": self.qsr_beta,
            "warmup": self.warmup,
            "warmup_rounds": sum(1 for r in plan if r["warmup"]),
            "overlap": self.overlap,
            "staleness": depth,
            "rounds": self.total_rounds,
            "fixed_rounds": self.fixed_rounds,
            "allreduces_saved": self.fixed_rounds - self.total_rounds,
            "tau_min": min(taus),
            "tau_max": max(taus),
            "plan": plan,
        }
        if inner:
            out["inner_rounds"] = self.inner_rounds
            out["inner_pull"] = self.inner_pull
        return out

    def plan_table(self, max_rows: int = 12) -> str:
        """The round plan as a markdown table. Long plans elide the
        middle, keeping the first and last ``max_rows // 2`` rounds."""
        d = self.describe()
        rows = d["plan"]
        extra = ""
        if d["warmup"]:
            extra += (f", warmup {d['warmup']} steps = "
                      f"{d['warmup_rounds']} rounds")
        if d["overlap"] != "none":
            extra += f", overlap {d['overlap']} (k={d['staleness']})"
            if d["tau_schedule"] == "qsr":
                extra += " (stale-LR QSR)"
        if d.get("inner_rounds"):
            extra += (f", inner/outer plan x{d['inner_rounds']} "
                      f"(inner pull {d['inner_pull']})")
        head = [f"round plan: {d['rounds']} rounds over "
                f"{d['total_steps']} steps (tau_schedule="
                f"{d['tau_schedule']}, tau {d['tau_min']}..{d['tau_max']}, "
                f"all-reduces saved vs fixed: {d['allreduces_saved']}"
                f"{extra})",
                "| round | start | tau | lam | lr window | staleness |",
                "|---|---|---|---|---|---|"]
        if len(rows) > max_rows:
            half = max(max_rows // 2, 1)
            shown = list(rows[:half]) + [None] + list(rows[-half:])
        else:
            shown = rows
        for r in shown:
            if r is None:
                head.append("| ... | | | | | |")
                continue
            tau_cell = f"{r['tau']} (warm)" if r["warmup"] else f"{r['tau']}"
            if r.get("scope") == "inner":
                tau_cell += " (inner)"
            head.append(f"| {r['round']} | {r['start']} | {tau_cell} | "
                        f"{r['lam']:.4f} | {r['lr_start']:.4f} -> "
                        f"{r['lr_end']:.4f} | {r['staleness']} |")
        return "\n".join(head)


class RoundMetricsLogger:
    """Per-round metrics hook: one JSON line per communication round, as
    the reference's ``RoundMetricsLogger`` writes it.

    Called with the round's ``RoundSpec`` (or, for the per-step DDP
    loop, a plain step index) and the unified round-metrics dict every
    round step emits (``consensus_dist`` / ``pre_dist`` /
    ``pull_force`` / ``push_force`` / ``train_loss`` / ``lam_t`` /
    ``staleness``). Each line carries the clock position (round, global
    start step, tau) and the metrics as floats; ``staleness`` is the depth
    of the consensus the round applied (0 = exact). A legacy boolean
    ``stale`` key is read as ``staleness``; ``legacy=True`` writes the
    boolean next to it. ``launch/train.py --log-every-round PATH`` wires
    it (``--legacy-metrics`` for the boolean).
    """

    def __init__(self, path: str, *, legacy: bool = False):
        self.path = path
        self.legacy = legacy
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "w")

    def __call__(self, spec, metrics: dict):
        if isinstance(spec, RoundSpec):
            row = {"round": spec.index, "start": spec.start, "tau": spec.tau}
        else:   # the per-step DDP loop: a bare global step index
            row = {"round": int(spec), "start": int(spec), "tau": 1}
        for k, v in metrics.items():
            if k == "stale":
                if "staleness" in metrics:
                    continue
                k = "staleness"
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        if self.legacy and "staleness" in row:
            row["stale"] = bool(row["staleness"] > 0)
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        return row

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
