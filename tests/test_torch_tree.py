"""The port's tree engine and DDP step against the JAX package's, on the
same numpy inputs: ``core/pullpush.py`` function by function,
``apply_round(engine=None)`` for every method and push variant, the tree
trainer (the README quickstart, per-round MLP parity, one round of the
reduced yi-6b), ``make_ddp_step`` and the launcher's ``--engine tree`` /
``--method ddp``.

The port's tree path is held against the REFERENCE's tree path, never
against the port's flat engine: the reference's own tree and flat
trainers differ by more than 1e-4 (ROADMAP.md Queue 3). On CPU tensors
the ``sq_dist`` / ``apply_update`` wrappers run their plain versions, which
``tests/test_torch_kernels.py`` holds against the reference's kernels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import (
    default_data, error_pct, mlp_init, mlp_loss, round_batches,
    run_distributed, worker_shards,
)
from repro.configs import DPPFConfig as JDPPFConfig
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.core import consensus as jcons
from repro.core import pullpush as jpp
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import RoundClock as JRoundClock
from repro.train import TrainState as JTrainState
from repro.train import init_train_state as jinit_train_state
from repro.train import make_ddp_step as jmake_ddp_step
from repro.train import make_round_step as jmake_round_step
from repro_torch.configs import DPPFConfig, get_arch, reduced
from repro_torch.core import consensus
from repro_torch.core import pullpush as pp
from repro_torch.core.engine import tree_items
from repro_torch.data import classification_task
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    RoundClock, TrainState, average_params, init_train_state, make_ddp_step,
    make_round_step, stacked_params,
)
from test_torch_kernels import bf16_ulp
from test_torch_round import _mlp_loss
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)


DTYPES = ("float32", "bfloat16")
LOSSES = [3.0, 1.0, 2.0, 4.0]
GNS = [1.0, 2.0, 0.5, 1.0]


def _stacked(dtype, M=4, seed=7):
    """tests/test_engine.py's shapes (M = 4; (33, 7), (17,), (5, 3, 2)) as
    (jax tree, torch tree) with the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    np_tree = {"w": rng.normal(size=(M, 33, 7)), "b": rng.normal(size=(M, 17)),
               "s": rng.normal(size=(M, 5, 3, 2))}
    j = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in np_tree.items()}
    t = {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
         .to(getattr(torch, dtype)) for k, v in j.items()}
    return j, t


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _close(got, want, what=""):
    """fp32 within atol 1e-6 / rtol 1e-5; bf16 within one bf16 ulp of the
    output's scale."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=bf16_ulp(np.abs(w).max()),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=what)


def _same_tree(got, want, what=""):
    gi = dict(tree_items(got))
    assert sorted(gi) == sorted((k,) for k in want)
    for k in want:
        _close(gi[(k,)], want[k], f"{what} leaf {k}")


def _dists(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# core/pullpush.py against repro.core.pullpush
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_distances_match_reference(dtype):
    j, t = _stacked(dtype)
    jc, c = jpp.tree_mean0(j), pp.tree_mean0(t)
    _same_tree(c, jc, "tree_mean0")
    assert all(leaf.dtype == torch.float32 for _, leaf in tree_items(c))
    _dists(pp.worker_sq_dists(t, c), jpp.worker_sq_dists(j, jc))
    _dists(pp.worker_dists(t), jpp.worker_dists(j))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pullpush_matches_reference(dtype):
    j, t = _stacked(dtype)
    jnew, jm = jpp.pullpush(j, 0.3, 0.4)
    new, m = pp.pullpush(t, 0.3, 0.4)
    _same_tree(new, jnew, "pullpush")
    assert sorted(m) == sorted(jm)
    for k in m:
        _dists(m[k], jm[k])


@pytest.mark.parametrize("dtype", DTYPES)
def test_pull_and_push_match_reference(dtype):
    j, t = _stacked(dtype)
    jc, c = jpp.tree_mean0(j), pp.tree_mean0(t)
    for alpha in (0.3, 1.0):
        _same_tree(pp.pull_only(t, c, alpha), jpp.pull_only(j, jc, alpha),
                   f"pull_only {alpha}")
    # hard pull lands on the center exactly
    hard = pp.pull_only(t, c, 1.0)
    assert float(pp.worker_dists(hard).max()) == 0.0
    _same_tree(pp.push_only(t, 0.4), jpp.push_only(j, 0.4), "push mean")
    # the lsgd leader: an fp32 center without the worker dimension
    jl = jax.tree.map(lambda a: a.astype(jnp.float32)[1], j)
    leader = {k: v[1].float() for k, v in t.items()}
    _same_tree(pp.push_only(t, 0.4, center=leader),
               jpp.push_only(j, 0.4, center=jl), "push leader")
    inplace = {k: v.clone() for k, v in t.items()}
    out = pp.push_only(inplace, 0.4, out=inplace)
    assert all(out[k].data_ptr() == inplace[k].data_ptr() for k in t)
    _same_tree(inplace, jpp.push_only(j, 0.4), "push in place")


@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_push_and_terms_match_reference(dtype):
    j, t = _stacked(dtype)
    _same_tree(pp.exact_push(t, 1.6), jpp.exact_push(j, 1.6), "exact_push")
    for got, want in zip(pp.push_terms_norms(t, 1.6),
                         jpp.push_terms_norms(j, 1.6)):
        _dists(got, want)


def test_tree_round_calls_the_kernels_per_worker_and_leaf(monkeypatch):
    """One ``sq_dist`` per (worker, leaf) for each distance and one
    ``apply_update`` per (worker, leaf) for each update: M x 3 leaves
    each for Eq. 5; the pull-then-push route (easgd) takes three sets of
    distances (pre, the push's, post) and one update."""
    calls = {"sq_dist": 0, "apply_update": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    for name in calls:
        monkeypatch.setattr(pp, name, counted(name, getattr(pp, name)))
    _, t = _stacked("bfloat16")
    for method, want in (("simple_avg", (12, 12)), ("easgd", (36, 12))):
        calls.update(sq_dist=0, apply_update=0)
        consensus.apply_round(t, DPPFConfig(consensus=method), 0.25,
                              consensus.init_state(method, t))
        assert (calls["sq_dist"], calls["apply_update"]) == want, method


# ---------------------------------------------------------------------------
# apply_round(engine=None) against the reference's tree path
# ---------------------------------------------------------------------------

CASES = [dict(push=False), dict(push=True),
         dict(push=True, exact_second_term=True)]


@pytest.mark.parametrize("method", consensus.METHODS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_round_tree_matches_reference(method, dtype):
    """Every method, push off / on / exact second term, push from the
    average and from the leader: params, the center state and the four
    metrics."""
    assert consensus.METHODS == jcons.METHODS
    j, t = _stacked(dtype)
    for case in CASES:
        for push_from in ("average", "leader"):
            jd = JDPPFConfig(alpha=0.3, lam=0.4, consensus=method, **case)
            pd = DPPFConfig(alpha=0.3, lam=0.4, consensus=method, **case)
            jnew, jst, jm = jcons.apply_round(
                j, jd, 0.25, jcons.init_state(method, j),
                losses=jnp.asarray(LOSSES), grad_norms=jnp.asarray(GNS),
                push_from=push_from)
            new, st, m = consensus.apply_round(
                t, pd, 0.25, consensus.init_state(method, t),
                losses=torch.tensor(LOSSES), grad_norms=torch.tensor(GNS),
                push_from=push_from)
            what = f"{method} {case} {push_from}"
            _same_tree(new, jnew, what)
            assert sorted(st) == sorted(jst)
            if "center" in st:
                _same_tree(st["center"], jst["center"], what + " center")
            assert sorted(m) == sorted(jm)
            for k in m:
                np.testing.assert_allclose(_np(m[k]), _np(jm[k]), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{what} {k}")
            if method == "hard" and not case["push"]:
                assert float(m["consensus_dist"]) == 0.0


def test_tree_path_refuses_flat_only_inputs():
    _, t = _stacked("float32")
    for kw in (dict(first_gram=torch.zeros(4, 4)), dict(mask=[1.0] * 4),
               dict(push_vec=torch.zeros(4, 8))):
        with pytest.raises(ValueError, match="flat engine"):
            consensus.apply_round(t, DPPFConfig(), 0.1, {}, **kw)
    with pytest.raises(ValueError, match="flat engine"):
        consensus.apply_round(t, DPPFConfig(consensus="lpf_sgd",
                                            engine="flat"), 0.1, {})


# ---------------------------------------------------------------------------
# the tree trainer and the DDP step
# ---------------------------------------------------------------------------

def _mlp_init(p0):
    return lambda gen, device: {
        l: {k: torch.tensor(v, device=device) for k, v in d.items()}
        for l, d in p0.items()}


def _mlp_batch(b):
    return {"x": torch.tensor(np.asarray(b["x"])),
            "y": torch.from_numpy(np.asarray(b["y"]).astype(np.int64))}


def test_quickstart_width_matches_reference_on_the_tree_engine():
    """README quickstart: ``run_distributed`` at M=4, 300 steps (75
    rounds) on the reference's default engine, the tree engine, against
    the port's tree trainer on the same data and init. The width must
    agree within 1e-3, and ``params_avg``'s train and test errors within
    0.5 points. Its parameters are not compared entry by entry: after
    300 steps the reference's own ``params_avg`` moves by more than 1e-3
    when its initial params move by 1e-7
    (``test_reference_quickstart_params_move_under_a_tiny_perturbation``).
    ``test_mlp_tree_rounds_match_reference`` holds the first rounds'
    parameters to 1e-5."""
    M, steps, bs, lr = 4, 300, 64, 0.05
    jdata = default_data()
    want = run_distributed(jdata, JDPPFConfig(alpha=0.1, lam=0.5, tau=4),
                           M=M, steps=steps)

    data = classification_task(device="cpu")
    p0 = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0),
                                           data["dim"], data["n_classes"]))
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=4)
    assert dcfg.engine == "tree"
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    state = init_train_state(_mlp_init(p0), opt, dcfg, M, None,
                             device="cpu")
    assert state.engine is None
    clock = RoundClock.from_config(dcfg, base_lr=lr, total_steps=steps)
    step = make_round_step(_mlp_loss, opt, dcfg, clock=clock)
    shards = worker_shards(len(data["x_train"]), M, 0)
    rng = np.random.default_rng(1)
    for spec in clock.rounds:
        state, _ = step(state, _mlp_batch(round_batches(
            data, shards, rng, spec.tau, M, bs)))
    width = float(pp.worker_dists(stacked_params(state)).mean())
    assert abs(width - want.consensus_dist) < 1e-3, (width,
                                                     want.consensus_dist)
    avg = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                       average_params(state))
    for k in ("train", "test"):
        got = error_pct(avg, jdata[f"x_{k}"], jdata[f"y_{k}"])
        ref = error_pct(want.params_avg, jdata[f"x_{k}"], jdata[f"y_{k}"])
        assert abs(got - ref) <= 0.5, (k, got, ref)


def test_reference_quickstart_params_move_under_a_tiny_perturbation():
    """Why the quickstart test compares ``params_avg`` through its errors:
    the reference's own tree trainer on the quickstart setup, restarted
    from initial params moved by an additive normal 1e-7, ends with
    ``params_avg`` more than 1e-3 away for some of four such moves (a
    ReLU pre-activation changes sign on a rounding difference, and the
    runs part), while its train and test errors stay within 0.5 points."""
    from repro.train import average_params as javerage_params
    M, steps, bs, lr = 4, 300, 64, 0.05
    data = default_data()
    dcfg = JDPPFConfig(alpha=0.1, lam=0.5, tau=4)
    opt = jmake_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = JRoundClock.from_config(dcfg, base_lr=lr, total_steps=steps)
    step = jax.jit(jmake_round_step(mlp_loss, opt, dcfg, clock=clock))
    p0 = mlp_init(jax.random.PRNGKey(0), data["dim"], data["n_classes"])

    def run(init):
        state = jinit_train_state(lambda k: init, opt, dcfg, M,
                                  jax.random.PRNGKey(0))
        shards = worker_shards(len(data["x_train"]), M, 0)
        rng = np.random.default_rng(1)
        for spec in clock.rounds:
            state, _ = step(state, round_batches(data, shards, rng,
                                                 spec.tau, M, bs))
        return javerage_params(state)

    errs = lambda p: [error_pct(p, data[f"x_{k}"], data[f"y_{k}"])
                      for k in ("train", "test")]
    base = run(p0)
    moved = []
    for seed in range(4):
        noise = np.random.default_rng(seed)
        avg = run(jax.tree.map(lambda a: a + 1e-7 * noise.normal(
            size=a.shape).astype(np.float32), p0))
        moved.append(max(float(jnp.abs(a - b).max()) for a, b in zip(
            jax.tree.leaves(avg), jax.tree.leaves(base))))
        assert np.allclose(errs(avg), errs(base), rtol=0, atol=0.5)
    assert max(moved) > 1e-3, moved


@pytest.mark.parametrize("method, optimizer, sam_rho", [
    ("simple_avg", "sgd", 0.0), ("lsgd", "adamw", 0.0),
    ("mgrawa", "sgd", 0.05), ("easgd", "sgd", 0.0),
])
def test_mlp_tree_rounds_match_reference(method, optimizer, sam_rho):
    """Five rounds of the benchmark MLP through both tree trainers: the
    optimizers over trees (AdamW's per-worker step count), SAM, the loss /
    grad-norm plumbing and the center state."""
    M, tau, bs, steps = 4, 2, 16, 10
    data = classification_task(device="cpu")
    jp0 = mlp_init(jax.random.PRNGKey(1), data["dim"], data["n_classes"], 16)
    p0 = jax.tree.map(np.asarray, jp0)
    dkw = dict(alpha=0.2, lam=0.3, tau=tau, consensus=method,
               lam_schedule="fixed")
    jd, pd = JDPPFConfig(**dkw), DPPFConfig(**dkw)
    okw = dict(momentum=0.9, weight_decay=1e-3)
    jopt, opt = jmake_optimizer(optimizer, **okw), make_optimizer(optimizer,
                                                                  **okw)
    jstate = jinit_train_state(lambda k: jp0, jopt, jd, M,
                               jax.random.PRNGKey(0))
    state = init_train_state(_mlp_init(p0), opt, pd, M, None, device="cpu")
    jclock = JRoundClock.from_config(jd, base_lr=0.05, total_steps=steps)
    clock = RoundClock.from_config(pd, base_lr=0.05, total_steps=steps)
    jstep = jax.jit(jmake_round_step(mlp_loss, jopt, jd, clock=jclock,
                                     sam_rho=sam_rho))
    step = make_round_step(_mlp_loss, opt, pd, clock=clock, sam_rho=sam_rho)
    shards = worker_shards(len(data["x_train"]), M, 0)
    rng = np.random.default_rng(2)
    for spec in clock.rounds:
        b = round_batches(data, shards, rng, spec.tau, M, bs)
        jstate, jm = jstep(jstate, b)
        state, m = step(state, _mlp_batch(b))
        for k in ("consensus_dist", "train_loss", "pull_force", "pre_dist"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-6)
    for l, d in jstate.params.items():
        for k, v in d.items():
            np.testing.assert_allclose(state.params[l][k].numpy(),
                                       np.asarray(v), rtol=1e-5, atol=1e-5)
    if method == "easgd":
        for l, d in jstate.cstate["center"].items():
            for k, v in d.items():
                np.testing.assert_allclose(
                    state.cstate["center"][l][k].numpy(), np.asarray(v),
                    rtol=1e-5, atol=1e-5)
    if optimizer == "adamw":
        np.testing.assert_array_equal(state.opt["t"].numpy(),
                                      np.asarray(jstate.opt["t"]))


def test_ddp_matches_reference():
    """``run_distributed(consensus="ddp")``, 40 steps, against the port's
    ``make_ddp_step`` on the same data and init: params within 1e-5."""
    M, steps, bs, lr = 4, 40, 64, 0.05
    jdata = default_data()
    want = run_distributed(jdata, JDPPFConfig(consensus="ddp"), M=M,
                           steps=steps)
    data = classification_task(device="cpu")
    p0 = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0),
                                           data["dim"], data["n_classes"]))
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    params = _mlp_init(p0)(None, "cpu")
    state = TrainState(params=params, opt=opt.init(params), cstate={})
    step = make_ddp_step(_mlp_loss, opt, base_lr=lr, total_steps=steps)
    shards = worker_shards(len(data["x_train"]), M, 0)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        b = round_batches(data, shards, rng, 1, M, bs)
        state, m = step(state, {k: v[0] for k, v in _mlp_batch(b).items()})
    assert state.t == steps and float(m["consensus_dist"]) == 0.0
    for l, d in want.params_avg.items():
        for k, v in d.items():
            np.testing.assert_allclose(state.params[l][k].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-5)


def test_ddp_step_matches_reference_with_sam_and_adamw():
    """Three DDP steps with AdamW and SAM: the optimizer and SAM on one
    replica's tree, and the metrics schema."""
    data = classification_task(device="cpu")
    jp0 = mlp_init(jax.random.PRNGKey(3), data["dim"], data["n_classes"], 16)
    p0 = jax.tree.map(np.asarray, jp0)
    jopt, opt = jmake_optimizer("adamw"), make_optimizer("adamw")
    jstate = JTrainState(params=jp0, opt=jopt.init(jp0), cstate={},
                         t=jnp.zeros((), jnp.int32))
    params = _mlp_init(p0)(None, "cpu")
    state = TrainState(params=params, opt=opt.init(params), cstate={})
    assert state.opt["t"].shape == ()
    jstep = jax.jit(jmake_ddp_step(mlp_loss, jopt, base_lr=0.05,
                                   total_steps=3, sam_rho=0.05))
    step = make_ddp_step(_mlp_loss, opt, base_lr=0.05, total_steps=3,
                         sam_rho=0.05)
    shards = worker_shards(len(data["x_train"]), 4, 0)
    rng = np.random.default_rng(4)
    for _ in range(3):
        b = round_batches(data, shards, rng, 1, 4, 16)
        jstate, jm = jstep(jstate, jax.tree.map(lambda a: a[0], b))
        state, m = step(state, {k: v[0] for k, v in _mlp_batch(b).items()})
        assert sorted(m) == sorted(jm)
        np.testing.assert_allclose(float(m["train_loss"]),
                                   float(jm["train_loss"]), rtol=1e-5)
    for l, d in jstate.params.items():
        for k, v in d.items():
            np.testing.assert_allclose(state.params[l][k].numpy(),
                                       np.asarray(v), rtol=1e-5, atol=1e-5)


def test_one_tree_round_of_reduced_yi6b_matches_reference():
    """reduced(yi-6b), M=4, tau=2, on the tree engine in both packages:
    params and metrics at tests/test_torch_round.py's tolerances."""
    M, tau, B, S = 4, 2, 2, 16
    jcfg, cfg = jreduced(jget_arch("yi-6b")), reduced(get_arch("yi-6b"))
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    dkw = dict(alpha=0.1, lam=0.5, tau=tau, lam_schedule="fixed")
    jd, pd = JDPPFConfig(**dkw), DPPFConfig(**dkw)
    assert jd.engine == pd.engine == "tree"
    jopt = jmake_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    jstate = jinit_train_state(lambda k: jparams, jopt, jd, M,
                               jax.random.PRNGKey(0))
    jclock = JRoundClock.from_config(jd, base_lr=0.1, total_steps=2 * tau)
    jstep = jax.jit(jmake_round_step(jmodel.loss, jopt, jd, clock=jclock))
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    state = init_train_state(
        lambda gen, device: params_from_numpy(cfg, np_params, device=device),
        opt, pd, M, None, device="cpu")
    clock = RoundClock.from_config(pd, base_lr=0.1, total_steps=2 * tau)
    step = make_round_step(build_model(cfg).loss, opt, pd, clock=clock)

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(tau, M, B, S))
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -1] = -1
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens, jnp.int32),
                                "labels": jnp.asarray(labels, jnp.int32)})
    state, m = step(state, {"tokens": torch.from_numpy(tokens),
                            "labels": torch.from_numpy(labels)})
    got = dict(tree_items(state.params))
    want = {tuple(getattr(k, "key", k) for k in path): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(want[path]),
                                   rtol=1e-4, atol=1e-4, err_msg=str(path))
    for k in ("consensus_dist", "train_loss", "pre_dist", "push_force"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=1e-4, atol=1e-4)
    assert state.round == 1 and state.t == tau


@pytest.mark.parametrize("flags", [["--engine", "tree"],
                                   ["--method", "ddp"],
                                   ["--engine", "tree", "--method", "easgd"]])
def test_launcher_tree_and_ddp_on_cpu(flags, capsys):
    from repro_torch.launch.train import main
    loss = main(["--arch", "yi-6b", "--smoke", "--workers", "4", "--tau",
                 "2", "--steps", "4", "--seq", "16", "--batch", "2",
                 "--log-every", "1", *flags], device="cpu")
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert ("step     0 loss" in out) == ("ddp" in flags)
