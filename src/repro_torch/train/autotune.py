"""The ``--autotune`` probe search (counterpart of
``repro/train/autotune.py``, with the same search, the same ``TunePlan``
schema and the same byte-stable JSON).

The operating point is a per-worker batch, tau and ``overlap_chunks``:

1. **Batch frontier** — batches double from ``TuneSpace.min_batch`` until
   the first OOM (or ``max_batch``); a binary search then refines between
   the largest feasible and the smallest failed size. A failed size is
   never probed again; every probe counts against ``probe_budget``, and
   the search returns its best point so far when the budget runs out.
2. **Joint sweep** — every (tau, chunks) pair of the ladders at the
   frontier batch (chunks capped by tau; modes without chunks collapse the
   ladder to ``(1,)``).
3. **Reconciled scoring** — each probe records its measured round time
   and the roofline model's (``launch/roofline.py::probe_round_model``).
   The median measured / modeled ratio calibrates the model, and the
   candidates are ranked by calibrated microseconds a sample
   (``round_us / (tau * batch)``). One positive scale never moves the
   argmin, so the chosen point depends only on the feasibility frontier.

**The OOM contract** (``is_oom``): a probe failed for memory when the
exception's type name or message carries one of ``OOM_TOKENS``. PyTorch's
``torch.cuda.OutOfMemoryError("CUDA out of memory. ...")`` matches; so does
the scripted ``RESOURCE_EXHAUSTED`` of ``inject_oom_above`` and of the
chaos plans. Any other exception propagates.

A real OOM leaves the failed probe's tensors reachable from the
exception's traceback. ``make_round_probe_runner`` builds each probe's
fleet in a frame of its own, drops the exception before it frees the
cache, and raises a fresh ``torch.cuda.OutOfMemoryError`` that holds only
the message, so the next probe starts from the memory the last one found.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

import repro_torch.launch.roofline as rf
from repro_torch.train.clock import OVERLAP_MODES

PLAN_VERSION = 1

# substrings that mark an exception as device memory exhaustion: the
# reference's tokens. The first is jaxlib's status and the injection
# contract; "out of memory" matches PyTorch's
# ``torch.cuda.OutOfMemoryError("CUDA out of memory. ...")`` too
OOM_TOKENS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
              "OOM")

# overlap modes whose chunk ladder means something (the others dispatch no
# mid-scan chunks, so their ladder collapses to (1,))
_CHUNKED_MODES = ("doublebuf", "staleness_k")


def is_oom(exc: BaseException) -> bool:
    """Does this exception mean the step ran out of device memory? Matched
    on the type name and message, so a scripted ``InjectedOOM`` (a plain
    RuntimeError) and the allocator's own error both match. Everything
    else is a real fault and must propagate."""
    text = f"{type(exc).__name__}: {exc}"
    return any(tok in text for tok in OOM_TOKENS)


@dataclass(frozen=True)
class Candidate:
    """One operating point of the joint search space."""
    batch: int            # per-worker batch size
    tau: int              # local steps per communication round
    overlap_chunks: int   # chunks of the snapshot's column contraction


@dataclass(frozen=True)
class TuneSpace:
    """The search space and budget. ValueError on a malformed space (these
    guard the launcher's ``--autotune`` flags)."""
    min_batch: int = 1
    max_batch: int = 256
    taus: Tuple[int, ...] = (4, 8)
    chunks: Tuple[int, ...] = (1, 2, 4)
    probe_budget: int = 16
    overlap: str = "doublebuf"
    staleness: int = 1

    def __post_init__(self):
        if self.probe_budget < 1:
            raise ValueError(
                f"probe_budget must be >= 1, got {self.probe_budget}")
        if self.min_batch < 1:
            raise ValueError(f"min_batch must be >= 1, got {self.min_batch}")
        if self.min_batch > self.max_batch:
            raise ValueError(
                f"min_batch {self.min_batch} > max_batch {self.max_batch}")
        if not self.taus or any(t < 1 for t in self.taus):
            raise ValueError(f"taus must be a non-empty tuple of ints >= 1, "
                             f"got {self.taus!r}")
        if not self.chunks or any(c < 1 for c in self.chunks):
            raise ValueError(f"chunks must be a non-empty tuple of ints >= "
                             f"1, got {self.chunks!r}")
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(f"unknown overlap mode {self.overlap!r}")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {self.staleness}")

    def chunk_ladder(self) -> Tuple[int, ...]:
        """The chunk ladder that applies: modes without mid-scan chunks
        have nothing to tune there."""
        if self.overlap in _CHUNKED_MODES:
            return self.chunks
        return (1,)


@dataclass(frozen=True)
class ProbeResult:
    """One probe: the candidate, whether it fit, the measured round time
    (host-relative) and the roofline model's round time."""
    batch: int
    tau: int
    overlap_chunks: int
    ok: bool
    us_round: float = 0.0     # measured; 0.0 for a failed probe
    modeled_us: float = 0.0   # roofline.probe_round_model
    error: str = ""           # the OOM message when not ok

    @property
    def candidate(self) -> Candidate:
        return Candidate(self.batch, self.tau, self.overlap_chunks)


@dataclass(frozen=True)
class TunePlan:
    """What ``--autotune`` writes and ``RoundClock.from_tune_plan`` /
    ``DPPFConfig.apply_tune_plan`` read. The chosen point, the probe
    ladder, the failures, the budget and ``dominates_model`` depend only
    on the feasibility frontier; ``us_round``, ``residual_scale`` and
    ``dominates_measured`` are the host's timings."""
    chosen: Candidate
    probes: Tuple[ProbeResult, ...]
    failures: Tuple[int, ...]     # batch sizes that OOMed (sorted, unique)
    probe_budget: int
    probes_used: int
    overlap: str
    staleness: int
    residual_scale: float         # median(measured / modeled), ok probes
    dominates_model: bool         # chosen beats every ok probe, calibrated
    dominates_measured: bool      # the same on raw measured time
    version: int = PLAN_VERSION

    def __post_init__(self):
        # a hand-edited or wrong-version plan fails loudly instead of
        # training at a garbage operating point
        if self.version != PLAN_VERSION:
            raise ValueError(f"TunePlan version {self.version} != "
                             f"{PLAN_VERSION} (regenerate with --autotune)")
        if self.probe_budget < 1:
            raise ValueError(
                f"probe_budget must be >= 1, got {self.probe_budget}")
        if self.chosen.batch < 1 or self.chosen.tau < 1 \
                or self.chosen.overlap_chunks < 1:
            raise ValueError(f"malformed chosen point {self.chosen}")
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(f"unknown overlap mode {self.overlap!r}")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {self.staleness}")

    # -- deterministic JSON -------------------------------------------------

    def to_dict(self) -> dict:
        """JSON form. Floats are rounded here (µs to 0.1, the model and
        scale fields to 6 digits), so that a load -> save round trip is
        byte-identical, in either package."""
        return {
            "version": self.version,
            "chosen": {"batch": self.chosen.batch, "tau": self.chosen.tau,
                       "overlap_chunks": self.chosen.overlap_chunks},
            "overlap": self.overlap,
            "staleness": self.staleness,
            "probe_budget": self.probe_budget,
            "probes_used": self.probes_used,
            "failures": list(self.failures),
            "residual_scale": round(self.residual_scale, 6),
            "dominates_model": self.dominates_model,
            "dominates_measured": self.dominates_measured,
            "probes": [
                {"batch": p.batch, "tau": p.tau,
                 "overlap_chunks": p.overlap_chunks, "ok": p.ok,
                 "us_round": round(p.us_round, 1),
                 "modeled_us": round(p.modeled_us, 6), "error": p.error}
                for p in self.probes],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TunePlan":
        try:
            chosen = Candidate(int(d["chosen"]["batch"]),
                               int(d["chosen"]["tau"]),
                               int(d["chosen"]["overlap_chunks"]))
            probes = tuple(
                ProbeResult(int(p["batch"]), int(p["tau"]),
                            int(p["overlap_chunks"]), bool(p["ok"]),
                            float(p["us_round"]), float(p["modeled_us"]),
                            str(p.get("error", "")))
                for p in d["probes"])
            return cls(chosen=chosen, probes=probes,
                       failures=tuple(int(b) for b in d["failures"]),
                       probe_budget=int(d["probe_budget"]),
                       probes_used=int(d["probes_used"]),
                       overlap=str(d["overlap"]),
                       staleness=int(d["staleness"]),
                       residual_scale=float(d["residual_scale"]),
                       dominates_model=bool(d["dominates_model"]),
                       dominates_measured=bool(d["dominates_measured"]),
                       version=int(d.get("version", -1)))
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed TunePlan payload: {e!r}") from e

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path: str) -> "TunePlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def per_sample_us(us: float, cand: Candidate) -> float:
    """The objective: round microseconds a training sample (raw round time
    would always pick the smallest batch)."""
    return us / (cand.tau * cand.batch)


def autotune(runner: Callable[[Candidate], float],
             model_fn: Callable[[Candidate], float],
             space: TuneSpace) -> TunePlan:
    """Run the probe search. ``runner(cand)`` returns the measured round
    microseconds and raises on OOM (``is_oom`` decides; anything else
    propagates); ``model_fn(cand)`` returns the roofline model's round
    microseconds. ValueError when ``min_batch`` already OOMs."""
    probes: list = []
    tried: Dict[Candidate, ProbeResult] = {}

    def probe(cand: Candidate) -> Optional[ProbeResult]:
        if cand in tried:             # never again, failed sizes included
            return tried[cand]
        if len(tried) >= space.probe_budget:
            return None               # budget spent: best so far wins
        modeled = float(model_fn(cand))
        try:
            res = ProbeResult(cand.batch, cand.tau, cand.overlap_chunks,
                              ok=True, us_round=float(runner(cand)),
                              modeled_us=modeled)
        except Exception as e:        # noqa: BLE001 — filtered by is_oom
            if not is_oom(e):
                raise
            # only the message outlives the handler: the exception and its
            # traceback (the failed probe's frames) die with it
            res = ProbeResult(cand.batch, cand.tau, cand.overlap_chunks,
                              ok=False, modeled_us=modeled,
                              error=str(e)[:200])
        tried[cand] = res
        probes.append(res)
        return res

    # -- phase 1: power-of-two batch ladder at the base (tau, chunks) point
    base_tau, base_ch = space.taus[0], space.chunk_ladder()[0]
    b, best, first_fail = space.min_batch, 0, None
    while True:
        res = probe(Candidate(b, base_tau, base_ch))
        if res is None:
            break
        if res.ok:
            best = b
            if b >= space.max_batch:
                break
            b = min(b * 2, space.max_batch)
        else:
            first_fail = b
            break
    if best == 0:
        raise ValueError(
            f"autotune: no feasible batch — min_batch={space.min_batch} "
            f"already OOMs ({probes[-1].error if probes else 'no probe ran'}"
            f"); lower min_batch or shrink the model")

    # -- phase 2: binary refinement between largest-ok and smallest-failed;
    # midpoints lie strictly inside (lo, hi), so no tried size repeats
    lo, hi = best, first_fail
    while hi is not None and hi - lo > 1:
        res = probe(Candidate((lo + hi) // 2, base_tau, base_ch))
        if res is None:
            break
        if res.ok:
            lo = res.batch
        else:
            hi = res.batch
    best_batch = lo

    # -- phase 3: joint (tau, chunks) sweep at the frontier batch (the base
    # point is cached; chunk counts beyond tau cannot interleave)
    for tau in space.taus:
        for ch in space.chunk_ladder():
            if ch > tau:
                continue
            probe(Candidate(best_batch, tau, ch))

    # -- reconcile and select
    ok_probes = [p for p in probes if p.ok]
    rec = rf.reconcile_probes(
        (p.us_round, p.modeled_us) for p in ok_probes)
    scale = rec["scale"]

    def model_score(p: ProbeResult) -> float:
        return per_sample_us(p.modeled_us * scale, p.candidate)

    # the joint sweep's feasible probes at the frontier batch; ties
    # (chunking never changes the modeled payload) go to the smallest tau,
    # then the fewest chunks
    cands = [p for p in ok_probes if p.batch == best_batch]
    chosen_p = min(cands, key=lambda p: (model_score(p), p.tau,
                                         p.overlap_chunks))
    dominates_model = all(model_score(chosen_p) <= model_score(p)
                          for p in ok_probes)
    meas = lambda p: per_sample_us(p.us_round, p.candidate)
    dominates_measured = all(meas(chosen_p) <= meas(p) for p in ok_probes)

    return TunePlan(
        chosen=chosen_p.candidate, probes=tuple(probes),
        failures=tuple(sorted({p.batch for p in probes if not p.ok})),
        probe_budget=space.probe_budget, probes_used=len(tried),
        overlap=space.overlap, staleness=space.staleness,
        residual_scale=scale, dominates_model=dominates_model,
        dominates_measured=dominates_measured)


# ---------------------------------------------------------------------------
# probe runners
# ---------------------------------------------------------------------------

def inject_oom_above(runner: Callable[[Candidate], float],
                     max_ok_batch: int) -> Callable[[Candidate], float]:
    """The ``--tune-oom-above`` hook: a runner whose candidates with
    ``batch > max_ok_batch`` raise a scripted RESOURCE_EXHAUSTED before
    touching the device, so the backoff runs with a fixed frontier and no
    memory pressure."""
    if max_ok_batch < 1:
        raise ValueError(
            f"injected OOM frontier must be >= 1, got {max_ok_batch}")

    def run(cand: Candidate) -> float:
        if cand.batch > max_ok_batch:
            raise RuntimeError(
                f"RESOURCE_EXHAUSTED: injected OOM at batch={cand.batch} "
                f"(frontier {max_ok_batch})")
        return runner(cand)
    return run


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _release(device):
    """Collect the dead probe's cycles and hand its cached blocks back, so
    that the next probe's fleet starts from the same free memory."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def make_round_probe_runner(init_fn, loss_fn, opt, dcfg, workers: int,
                            batch_fn, *, base_lr: float = 0.05,
                            total_steps: int = 100, reps: int = 2,
                            seed: int = 0, device: str = "cuda"):
    """The measured probe runner on the real round step (the
    ``make_round_step`` the training loop runs). For each candidate: its
    tau and ``overlap_chunks`` go into ``dcfg``, a fresh fleet is built
    (``init_train_state`` from ``init_fn(gen, device)``, ``gen`` seeded
    with ``seed``), two rounds warm it, and the mean of ``reps`` timed
    rounds, with the device synchronized around the host clock, comes back
    in microseconds. ``batch_fn(cand)`` builds the ``(tau, M, batch, ...)``
    round batch on ``device``.

    Only one fleet is alive at a time: the probe's state lives in a frame
    that has returned before the runner returns or raises, and the cache
    is emptied after every probe. A device OOM comes back as a fresh
    ``torch.cuda.OutOfMemoryError`` with the allocator's message and no
    traceback into the failed probe. The cuBLAS handle and workspace are
    made here, before any probe, so that no probe meets their allocation
    under memory pressure."""
    from repro_torch.train.trainer import init_train_state, make_round_step

    if torch.device(device).type == "cuda":
        # a product and its backward in each dtype: the handles of this
        # thread and of the autograd engine's, and their workspaces
        a = torch.ones((8, 8), device=device, requires_grad=True)
        for dt in (torch.float32, torch.bfloat16):
            b = a.to(dt)
            (b @ b).float().sum().backward()
        torch.cuda.synchronize(device)
        del a, b

    def probe(cand: Candidate) -> float:
        dc = dataclasses.replace(dcfg, tau=cand.tau,
                                 overlap_chunks=cand.overlap_chunks)
        gen = torch.Generator(device=device).manual_seed(seed)
        st = init_train_state(init_fn, opt, dc, workers, gen, device=device)
        step = make_round_step(loss_fn, opt, dc, base_lr=base_lr,
                               total_steps=total_steps)
        b = batch_fn(cand)
        for _ in range(2):                      # warm: first use, caches
            st, _ = step(st, b)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            st, _ = step(st, b)
        _sync(device)
        return (time.perf_counter() - t0) / reps * 1e6

    def run(cand: Candidate) -> float:
        try:
            return probe(cand)
        except Exception as e:        # noqa: BLE001 — filtered by is_oom
            if not is_oom(e):
                raise
            kind = torch.cuda.OutOfMemoryError \
                if isinstance(e, torch.cuda.OutOfMemoryError) \
                else RuntimeError
            message = str(e)
        finally:
            # after an OOM the handler has ended here: the exception, its
            # traceback and the probe's frames are gone
            _release(device)
        raise kind(message)
    return run


def make_lm_model_fn(*, n_params: int, seq: int, workers: int,
                     overlap: str, staleness: int = 1):
    """The roofline ``model_fn`` of the training launcher: a local step is
    the LM rule's forward and backward, ~6 N flops a token; the consensus
    payload is the flat engine's worker-row gather (R x n fp32) plus the
    (R, R) partial-Gram all-reduce."""
    gather_bytes = workers * n_params * 4 + workers * workers * 4

    def model_us(cand: Candidate) -> float:
        work_s = 6.0 * n_params * cand.batch * seq / rf.PEAK_FLOPS
        return rf.probe_round_model(
            work_s_per_step=work_s, tau=cand.tau,
            gather_bytes=gather_bytes, R=workers, mode=overlap,
            staleness=staleness) * 1e6
    return model_us
