"""MethodSpec registry: every flat-minima consensus method as DATA.

Counterpart of ``repro/core/methods.py``: the same rows with the same
fields, and the same target-weight rules written on torch tensors.

A ``MethodSpec`` declares what ``core/consensus.py`` needs: the
target-weight rule ``weight_fn(ctx) -> (R,)`` of the flat lowering, the
tree path's target rule ``tree_target`` (the consensus target x_C of a
worker-stacked tree), the aux-row contract
(``aux_rows``/``aux_pull``/``center_beta``), the coefficient flags (``hard_pull``, ``fuse_eq5``, ``pushes``, ``leader``,
``pull_ramp``, ``push_source``), the loss / gradient inputs, the
inner/outer round plan (``inner_rounds``/``inner_pull``) and the
filtered-gradient state (``filter_mu``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import pullpush as pp
from repro_torch.core.engine import tree_map

EASGD_BETA = 0.9    # elastic-center step (paper §7.1 baseline setting)
PARLE_BETA = 0.5    # Parle couples replicas harder than EASGD's 0.9 mean
LPF_MU = 0.9        # LPF-SGD gradient-EMA coefficient (Bisla et al.)
ENTROPY_INNER_ROUNDS = 2   # Entropy-SGD: inner exploration + outer pull
ENTROPY_INNER_PULL = 0.25  # weak coupling of the non-final sub-rounds

PUSH_SOURCES = ("params", "filtered_grad")


@dataclasses.dataclass(frozen=True)
class WeightCtx:
    """Inputs a target-weight rule may read (all (R,)/(M,) fp32 tensors on
    the flat view's device)."""
    M: int
    R: int
    eye: Any                    # (R, R) fp32 identity
    u: Any                      # (R,) uniform over ACTIVE worker rows
    zeros: Any                  # (R,) fp32 zeros
    act: Any = None             # (M,) participation mask (1 = active) | None
    losses: Any = None          # (M,) per-worker losses | None
    grad_norms: Any = None      # (M,) per-worker grad norms | None


def _w_uniform(ctx: WeightCtx):
    return ctx.u


def _w_leader(ctx: WeightCtx):
    losses = torch.as_tensor(ctx.losses, dtype=torch.float32,
                             device=ctx.zeros.device)
    if ctx.act is not None:
        # inactive rows can't lead: their (frozen-iterate) losses are
        # masked out of the argmin
        losses = torch.where(ctx.act > 0, losses,
                             torch.full_like(losses, float("inf")))
    return torch.nn.functional.one_hot(torch.argmin(losses),
                                       ctx.R).to(torch.float32)


def _w_gradnorm(ctx: WeightCtx):
    gns = torch.as_tensor(ctx.grad_norms, dtype=torch.float32,
                          device=ctx.zeros.device)
    w = 1.0 / torch.clamp(gns, min=1e-12)
    if ctx.act is not None:
        w = w * ctx.act
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    out = ctx.zeros.clone()
    out[:ctx.M] = w
    return out


# -- tree-path targets: (x_C [no worker dim], new_state, leader_idx) -------

def _t_mean(spec, stacked, state, *, losses, grad_norms):
    return pp.tree_mean0(stacked), state, None


def _t_center(spec, stacked, state, *, losses, grad_norms):
    xa = pp.tree_mean0(stacked)
    z_new = tree_map(lambda zc, a: zc + spec.center_beta * (a - zc),
                    state["center"], xa)
    return z_new, {"center": z_new}, None


def _t_leader(spec, stacked, state, *, losses, grad_norms):
    if losses is None:
        raise ValueError(f"{spec.name} needs per-worker losses")
    idx = int(torch.argmin(torch.as_tensor(losses)))
    leader = tree_map(lambda a: a[idx].to(torch.float32), stacked)
    return leader, state, idx


def _t_gradnorm(spec, stacked, state, *, losses, grad_norms):
    if grad_norms is None:
        raise ValueError(f"{spec.name} needs per-worker grad norms")
    w = 1.0 / torch.clamp(torch.as_tensor(grad_norms, dtype=torch.float32),
                          min=1e-12)
    w = w / torch.sum(w)
    target = tree_map(lambda a: torch.tensordot(
        w.to(a.device), a.to(torch.float32), dims=([0], [0])), stacked)
    return target, state, None


def _t_flat_only(spec, stacked, state, *, losses, grad_norms):
    raise ValueError(f"{spec.name} requires the flat engine "
                     f"(set engine='flat')")


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One consensus method, declaratively (hashable)."""
    name: str
    doc: str                           # one-liner (CLI help)
    flags: str = ""                    # notable knobs
    weight_fn: Optional[Callable] = None   # None = no consensus stage (ddp)
    tree_target: Optional[Callable] = None
    needs_losses: bool = False
    needs_grad_norms: bool = False
    hard_pull: bool = False            # alpha := 1 (LocalSGD)
    pull_ramp: bool = False            # pull scales by lam_t / lam (Parle)
    leader: bool = False               # weight_fn emits a leader one-hot
    aux_rows: int = 0                  # extra state rows in the flat view
    aux_pull: float = 0.0              # aux rows' pull coefficient
    center_beta: float = 0.0           # >0: rows target the elastic center
    pushes: bool = True                # dcfg.push applies to this method
    fuse_eq5: bool = False             # pull+push fuse into one Eq.5 stage
    push_source: str = "params"        # "params" | "filtered_grad"
    filter_mu: float = 0.0             # EMA coef of cstate["g_ema"] (LPF)
    inner_rounds: int = 0              # >1: split rounds (Entropy-SGD)
    inner_pull: float = 1.0            # pull scale of non-final sub-rounds
    requires_flat: bool = False        # no tree path (flat engine only)

    def __post_init__(self):
        if self.aux_rows < 0:
            raise ValueError(f"{self.name}: aux_rows must be >= 0, got "
                             f"{self.aux_rows}")
        if self.aux_pull and not self.aux_rows:
            raise ValueError(f"{self.name}: aux_pull={self.aux_pull} needs "
                             f"aux_rows >= 1 (no aux row to pull)")
        if self.center_beta and not self.aux_rows:
            raise ValueError(f"{self.name}: center_beta={self.center_beta} "
                             f"needs aux_rows >= 1 (the center IS an aux "
                             f"row)")
        if not 0.0 <= self.center_beta <= 1.0:
            raise ValueError(f"{self.name}: center_beta must be in [0, 1], "
                             f"got {self.center_beta}")
        if self.push_source not in PUSH_SOURCES:
            raise ValueError(f"{self.name}: unknown push_source "
                             f"{self.push_source!r} (expected one of "
                             f"{PUSH_SOURCES})")
        if not 0.0 <= self.filter_mu < 1.0:
            raise ValueError(f"{self.name}: filter_mu must be in [0, 1), "
                             f"got {self.filter_mu}")
        if self.inner_rounds < 0:
            raise ValueError(f"{self.name}: inner_rounds must be >= 0, got "
                             f"{self.inner_rounds}")
        if not 0.0 < self.inner_pull <= 1.0:
            raise ValueError(f"{self.name}: inner_pull must be in (0, 1], "
                             f"got {self.inner_pull}")
        if self.push_source == "filtered_grad" and not self.filter_mu:
            raise ValueError(f"{self.name}: push_source='filtered_grad' "
                             f"needs filter_mu > 0 (the EMA buffer)")

    @property
    def communicates(self) -> bool:
        """Whether the method has a round-level consensus stage at all."""
        return self.weight_fn is not None


_REGISTRY: dict = {}
_ALIASES: dict = {}


def register(spec: MethodSpec, *, aliases: Tuple[str, ...] = ()) -> MethodSpec:
    if spec.name in _REGISTRY or spec.name in _ALIASES:
        raise ValueError(f"method {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    for a in aliases:
        if a in _REGISTRY or a in _ALIASES:
            raise ValueError(f"method alias {a!r} already registered")
        _ALIASES[a] = spec.name
    return spec


def get_method(name: str) -> MethodSpec:
    """Resolve a method (or alias) to its spec; ValueError on unknown."""
    spec = _REGISTRY.get(_ALIASES.get(name, name))
    if spec is None:
        raise ValueError(f"unknown consensus method {name!r} (registered: "
                         f"{', '.join(method_names())})")
    return spec


def method_names(*, aliases: bool = True) -> Tuple[str, ...]:
    """Registered names in registration order (canonical first)."""
    names = tuple(_REGISTRY)
    return names + tuple(sorted(_ALIASES)) if aliases else names


def tree_method_names() -> Tuple[str, ...]:
    """Canonical methods with a stacked-tree (tree) path — the flat
    engine's parity-oracle set."""
    return tuple(n for n, s in _REGISTRY.items() if not s.requires_flat)


register(MethodSpec(
    name="simple_avg",
    doc="DPPF soft consensus: pull to the worker mean + unit push away "
        "(paper Eq. 5, fused into one stage)",
    flags="fuses pull+push",
    weight_fn=_w_uniform, tree_target=_t_mean, fuse_eq5=True,
), aliases=("dppf",))

register(MethodSpec(
    name="hard",
    doc="LocalSGD: hard parameter averaging (alpha = 1; Stich'19)",
    flags="alpha forced to 1",
    weight_fn=_w_uniform, tree_target=_t_mean, hard_pull=True,
))

register(MethodSpec(
    name="easgd",
    doc="elastic averaging around a center z (Zhang et al.'15); z rides "
        "in the flat view's aux row",
    flags="center aux row (beta=%.2g)" % EASGD_BETA,
    weight_fn=_w_uniform, tree_target=_t_center,
    aux_rows=1, aux_pull=1.0, center_beta=EASGD_BETA,
))

register(MethodSpec(
    name="lsgd",
    doc="leader SGD: pull to the lowest-loss worker (Teng et al.'19); "
        "push_from='leader' is the paper's Remark 1 fix",
    flags="needs losses; leader push",
    weight_fn=_w_leader, tree_target=_t_leader,
    needs_losses=True, leader=True,
))

register(MethodSpec(
    name="mgrawa",
    doc="gradient-norm-weighted averaging, w_m ∝ 1/||grad_m|| "
        "(Dimlioglu'24)",
    flags="needs grad norms",
    weight_fn=_w_gradnorm, tree_target=_t_gradnorm, needs_grad_norms=True,
), aliases=("grawa",))

register(MethodSpec(
    name="ddp",
    doc="no round-level consensus (per-step gradient averaging in the "
        "trainer); metrics only",
    flags="no consensus stage",
))

register(MethodSpec(
    name="parle",
    doc="Parle elastic-averaging ensemble (Chaudhari et al.'17): center "
        "aux row + replica-coupling schedule (pull ramps with lam_t)",
    flags="center aux row; pull ramps with lam schedule; no push",
    weight_fn=_w_uniform, tree_target=_t_center,
    aux_rows=1, aux_pull=1.0, center_beta=PARLE_BETA,
    pull_ramp=True, pushes=False,
))

register(MethodSpec(
    name="lpf_sgd",
    doc="LPF-SGD (Bisla et al.'22): mean pull + push along the "
        "EMA-filtered gradient carried in TrainState",
    flags="flat engine only; g_ema state (mu=%.2g)" % LPF_MU,
    weight_fn=_w_uniform, tree_target=_t_flat_only,
    push_source="filtered_grad", filter_mu=LPF_MU, requires_flat=True,
))

register(MethodSpec(
    name="entropy_sgd",
    doc="Entropy-SGD (Chaudhari et al.'16): local-entropy inner loop as "
        "weak-pull sub-rounds on the RoundClock's inner/outer plan",
    flags="inner/outer round plan (%d sub-rounds); no push"
         % ENTROPY_INNER_ROUNDS,
    weight_fn=_w_uniform, tree_target=_t_mean, pushes=False,
    inner_rounds=ENTROPY_INNER_ROUNDS, inner_pull=ENTROPY_INNER_PULL,
))
