"""Soft-consensus family (paper §3 Alg. 1, §7.1) and their DPPF couplings.

Counterpart of ``repro/core/consensus.py``. Every method is a
``MethodSpec`` (``core/methods.py``). ``apply_round`` is the single entry
point: with ``engine=None`` it runs the stacked-tree path
(``_apply_round_tree``, over ``core/pullpush.py``: the reference's parity
oracle and its default engine); with a ``ConsensusEngine``
``lower_stages`` turns the spec into generic stages over the persistent
``(R, n)`` view. Every branch of both paths emits the same metrics dict:
``consensus_dist``, ``pre_dist``, ``pull_force``, ``push_force``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import methods as _methods
from repro_torch.core import pullpush as pp
from repro_torch.core.engine import tree_items, tree_map
from repro_torch.core.methods import get_method

# canonical methods with a tree path (lpf_sgd is flat-engine only)
METHODS = _methods.tree_method_names()


def init_state(method, params, *, engine=None):
    """Per-method consensus state. On the tree path the easgd/parle
    center is a tree (the initial worker mean); on the flat path LPF-SGD's
    filtered gradient is a worker-shaped EMA buffer and row-shaped state
    (the center) lives in the flat view's aux rows."""
    spec = get_method(method)
    if engine is None:
        if spec.center_beta:
            return {"center": pp.tree_mean0(params)}
        return {}
    if spec.filter_mu:
        L = engine.layout
        return {"g_ema": torch.zeros((L.M, L.n), dtype=torch.float32,
                                     device=engine.device)}
    return {}


def consensus_target(method, stacked, state, *, losses=None,
                     grad_norms=None):
    """Returns ``(x_C tree [no worker dim], new_state, leader_idx)``."""
    spec = get_method(method)
    if spec.tree_target is None:
        raise ValueError(method)
    return spec.tree_target(spec, stacked, state, losses=losses,
                            grad_norms=grad_norms)


def _metrics(consensus_dist, pre_dist, pull_force, push_force, *, device):
    """The ONE metrics schema every branch of every path emits."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)
    return {"consensus_dist": f(consensus_dist), "pre_dist": f(pre_dist),
            "pull_force": f(pull_force), "push_force": f(push_force)}


def _pull_coef(spec, dcfg, lam_t, pull_scale):
    """The effective pull coefficient: alpha, hard-pulled to 1, ramped by
    the replica-coupling schedule (Parle: lam_t / lam), and scaled by the
    clock's inner/outer plan (Entropy-SGD sub-rounds)."""
    pull = 1.0 if spec.hard_pull else dcfg.alpha
    if spec.pull_ramp and dcfg.lam > 0:
        pull = pull * (lam_t / dcfg.lam)
    return pull * pull_scale


def apply_round(params, dcfg, lam_t, state, *, losses=None, grad_norms=None,
                push_from="average", engine=None, first_gram=None, mask=None,
                push_vec=None, pull_scale=1.0):
    """One communication round. Returns ``(params, state, metrics)``.

    ``params`` is a worker-stacked tree (``engine=None``: new tensors come
    back, as in the reference) or the engine's flat ``(R, n)`` view (on
    the kernel path updated in place). ``mask`` (flat path only) is the
    elastic participation vector ``(M,)``; ``push_vec`` (flat path only)
    the ``(M, n)`` push field of ``push_source="filtered_grad"`` specs
    (LPF-SGD); ``first_gram`` (the overlap modes) is not ported yet."""
    if engine is not None:
        if first_gram is not None:
            raise NotImplementedError("not yet ported: first_gram "
                                      "(overlap)")
        return _apply_round_flat(engine, params, dcfg, lam_t, state,
                                 losses=losses, grad_norms=grad_norms,
                                 push_from=push_from, mask=mask,
                                 push_vec=push_vec, pull_scale=pull_scale)
    if first_gram is not None:
        raise ValueError("first_gram requires the flat engine")
    if mask is not None:
        raise ValueError("elastic mask requires the flat engine")
    if push_vec is not None:
        raise ValueError("push_vec requires the flat engine")
    return _apply_round_tree(params, dcfg, lam_t, state, losses=losses,
                             grad_norms=grad_norms, push_from=push_from,
                             pull_scale=pull_scale)


# ---------------------------------------------------------------------------
# Tree path: stacked trees (the flat engine's parity oracle)
# ---------------------------------------------------------------------------

def _apply_round_tree(stacked, dcfg, lam_t, state, *, losses, grad_norms,
                      push_from, pull_scale=1.0):
    spec = get_method(dcfg.consensus)
    pull = _pull_coef(spec, dcfg, lam_t, pull_scale)
    push = dcfg.push and spec.pushes
    dev = tree_items(stacked)[0][1].device

    if not spec.communicates:               # ddp: metrics only
        r = pp.worker_dists(stacked).mean()
        return stacked, state, _metrics(r, r, 0.0, 0.0, device=dev)

    if spec.fuse_eq5 and push and not dcfg.exact_second_term \
            and push_from == "average":
        new, m = pp.pullpush(stacked, pull, lam_t, dcfg.eps)
        return new, state, _metrics(m["consensus_dist"], m["pre_dist"],
                                    m["pull_force"], m["push_force"],
                                    device=dev)

    target, state, leader_idx = consensus_target(
        dcfg.consensus, stacked, state, losses=losses, grad_norms=grad_norms)
    pre = torch.mean(pp.worker_dists(stacked))
    new = pp.pull_only(stacked, target, pull)
    del target                  # dropped before the push allocates

    if push:
        if dcfg.exact_second_term:
            new = pp.exact_push(new, lam_t * _workers(new), dcfg.eps)
        elif push_from == "leader" and leader_idx is not None:
            leader = tree_map(lambda a: a[leader_idx].to(torch.float32), new)
            new = pp.push_only(new, lam_t, center=leader, eps=dcfg.eps,
                               out=new)
        else:
            new = pp.push_only(new, lam_t, eps=dcfg.eps, out=new)
    post = torch.mean(pp.worker_dists(new))
    return new, state, _metrics(post, pre, pull * pre,
                                lam_t if push else 0.0, device=dev)


def _workers(stacked):
    """M, the leading worker dimension of a stacked tree."""
    return tree_items(stacked)[0][1].shape[0]


def as_participation_mask(mask, n_workers, *, device="cpu"):
    """Canonicalize a membership provider's output to the
    ``(n_workers,)`` float32 participation vector (1.0 = in, 0.0 = out).
    Raises ``ValueError`` on a wrong shape."""
    act = torch.as_tensor(mask, dtype=torch.float32, device=device)
    if act.dim() != 1 or act.shape[0] != int(n_workers):
        raise ValueError(
            f"participation mask shape {tuple(act.shape)} != "
            f"({int(n_workers)},) (one entry per worker row)")
    return act


def _set(vec, stop, value):
    """``vec.at[:stop].set(value)`` — a new vector."""
    out = vec.clone()
    out[:stop] = value
    return out


def lower_stages(engine, dcfg, lam_t, *, losses=None, grad_norms=None,
                 push_from="average", mask=None, pull_scale=1.0):
    """Lower a consensus method's ``MethodSpec`` to its flat-engine stages.

    Returns ``(stages, pull)`` with each stage ``("coef", T, c0, c1)``,
    ``("exact", lam_r)`` or ``("vec", cvec)``; an empty list means no
    consensus stage (ddp). ``mask`` renormalizes the target weights over
    active rows and zeroes inactive rows' coefficients, so an inactive row
    passes through the mixing stages: exactly in the fast mode, and up to
    the gap form's rounding (``tx + 1 * (x - tx)``) in the kernel and
    precise modes, as in the reference.
    """
    spec = get_method(dcfg.consensus)
    pull = _pull_coef(spec, dcfg, lam_t, pull_scale)
    push = dcfg.push and spec.pushes
    L = engine.layout
    M, R = L.M, L.R
    dev = engine.device
    eye = torch.eye(R, dtype=torch.float32, device=dev)
    u = engine.uniform                       # (R,) worker mean weights
    zeros = torch.zeros((R,), dtype=torch.float32, device=dev)
    act = gate = None
    if mask is not None:
        act = as_participation_mask(mask, M, device=dev)
        mfull = _set(zeros, M, act)
        # masked uniform: the worker mean over active rows only
        u = mfull / torch.clamp(torch.sum(mfull), min=1.0)
        # aux rows follow the fleet while any worker is active and freeze
        # with it when everyone is out
        aux_on = (torch.sum(act) > 0).to(torch.float32)
        gate = _set(aux_on * torch.ones((R,), dtype=torch.float32,
                                        device=dev), M, act)

    def worker_T(w):
        """All worker rows target the combination w; aux rows stay put."""
        T = w.expand(R, R)
        if L.aux:
            T = torch.cat([T[:M], eye[M:]], dim=0)
        return T.contiguous()

    stages = []      # ("coef", T, c0, c1) | ("exact", lam_r) | ("vec", cvec)
    if spec.communicates:
        if spec.needs_losses and losses is None:
            raise ValueError(f"{spec.name} needs per-worker losses")
        if spec.needs_grad_norms and grad_norms is None:
            raise ValueError(f"{spec.name} needs grad norms")
        w = spec.weight_fn(_methods.WeightCtx(
            M=M, R=R, eye=eye, u=u, zeros=zeros, act=act, losses=losses,
            grad_norms=grad_norms))
        c_pull = _set(zeros, M, pull)
        if spec.fuse_eq5 and push and not dcfg.exact_second_term \
                and push_from == "average":
            # Eq. 5: pull and push share the x_A target -> ONE fused stage
            stages.append(("coef", worker_T(w), c_pull,
                           _set(zeros, M, -lam_t)))
        else:
            if spec.center_beta:
                # every row targets z' = beta (w.x) + (1-beta) z; the aux
                # row adopts it at aux_pull — one mixing stage
                w_z = spec.center_beta * w \
                    + (1.0 - spec.center_beta) * eye[M]
                T1 = w_z.expand(R, R).contiguous()
                c_pull = c_pull.clone()
                c_pull[M:] = spec.aux_pull
            else:
                T1 = worker_T(w)
            stages.append(("coef", T1, c_pull, zeros))
            if push:
                if spec.push_source == "filtered_grad":
                    stages.append(("vec", _set(zeros, M, -lam_t)))
                elif dcfg.exact_second_term:
                    stages.append(("exact", lam_t * M))
                elif push_from == "leader" and spec.leader:
                    stages.append(("coef", worker_T(w), zeros,
                                   _set(zeros, M, -lam_t)))
                else:
                    stages.append(("coef", worker_T(u), zeros,
                                   _set(zeros, M, -lam_t)))
    if gate is not None:
        if any(s[0] == "exact" for s in stages):
            raise ValueError("elastic mask does not support "
                             "exact_second_term stages")
        stages = [("coef", s[1], s[2] * gate, s[3] * gate)
                  if s[0] == "coef" else ("vec", s[1] * gate)
                  for s in stages]
    return stages, pull


def _apply_round_flat(engine, flat, dcfg, lam_t, state, *, losses, grad_norms,
                      push_from, mask=None, push_vec=None, pull_scale=1.0):
    spec = get_method(dcfg.consensus)
    if engine.eps != dcfg.eps:
        # the engine's norm guard must match the config's
        engine = dataclasses.replace(engine, eps=dcfg.eps)
    stages, pull = lower_stages(engine, dcfg, lam_t, losses=losses,
                                grad_norms=grad_norms, push_from=push_from,
                                mask=mask, pull_scale=pull_scale)
    if any(s[0] == "vec" for s in stages) and push_vec is None:
        raise ValueError(f"{spec.name} needs push_vec (the filtered-"
                         f"gradient field) on the flat path")

    pre = post = None
    for stage in stages:
        if stage[0] == "coef":
            _, T, c0, c1 = stage
            flat, _, s_pre, s_post = engine.stage(flat, T, c0, c1)
        elif stage[0] == "vec":
            _, cvec = stage
            flat, _, s_pre, s_post = engine.vec_stage(flat, push_vec, cvec)
        else:
            _, lam_r = stage
            flat, _, s_pre, s_post = engine.exact_stage(flat, lam_r)
        pre = s_pre if pre is None else pre
        post = s_post

    if post is None:                        # no consensus stage: metrics only
        pre = torch.mean(engine.dists_to_mean(flat))
        return flat, state, _metrics(pre, pre, 0.0, 0.0, device=flat.device)

    push = dcfg.push and spec.pushes
    return flat, state, _metrics(post, pre, pull * pre,
                                 lam_t if push else 0.0, device=flat.device)
