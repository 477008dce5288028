"""The port's DPPF round end to end against the JAX package: one round of
the reduced yi-6b on the kernel path, the README quickstart (the MLP on the
synthetic classification task, 300 steps), and the launcher's CPU smoke
run."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import (
    default_data, mlp_init, round_batches, run_distributed, worker_shards,
)
from repro.configs import DPPFConfig as JDPPFConfig
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.core.engine import ConsensusEngine as JEngine
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import RoundClock as JRoundClock
from repro.train import init_train_state as jinit_train_state
from repro.train import make_round_step as jmake_round_step
from repro_torch.configs import DPPFConfig, get_arch, reduced
from repro_torch.data import classification_task
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.train import RoundClock, init_train_state, make_round_step


def test_one_round_matches_reference_on_the_kernel_path():
    """reduced(yi-6b), M=4, tau=2: params and batches from the reference
    as numpy; the reference's Pallas kernel (interpret mode) against the
    port's kernel wrapper (its plain version on CPU tensors)."""
    M, tau, B, S = 4, 2, 2, 16
    jcfg, cfg = jreduced(jget_arch("yi-6b")), reduced(get_arch("yi-6b"))
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    dkw = dict(alpha=0.1, lam=0.5, tau=tau, engine="flat",
               lam_schedule="fixed")
    jd, pd = JDPPFConfig(**dkw), DPPFConfig(**dkw)

    jopt = jmake_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    jstacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (M,) + a.shape), jparams)
    # one wide column block keeps interpret mode's grid loop short
    jeng = JEngine.from_stacked(jstacked, use_kernel=True, interpret=True,
                                eps=jd.eps, block_cols=1 << 16)
    jstate = jinit_train_state(lambda k: jparams, jopt, jd, M,
                               jax.random.PRNGKey(0), engine=jeng)
    jclock = JRoundClock.from_config(jd, base_lr=0.1, total_steps=2 * tau)
    jstep = jax.jit(jmake_round_step(jmodel.loss, jopt, jd, clock=jclock))

    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    state = init_train_state(
        lambda gen, device: params_from_numpy(cfg, np_params, device=device),
        opt, pd, M, None, device="cpu")
    state.engine = dataclasses.replace(state.engine, use_kernel=True)
    clock = RoundClock.from_config(pd, base_lr=0.1, total_steps=2 * tau)
    step = make_round_step(build_model(cfg).loss, opt, pd, clock=clock)
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(jstate.params))

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(tau, M, B, S))
    labels = np.roll(tokens, -1, axis=-1)
    labels[..., -1] = -1
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens, jnp.int32),
                                "labels": jnp.asarray(labels, jnp.int32)})
    state, m = step(state, {"tokens": torch.from_numpy(tokens),
                            "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(jstate.params),
                               rtol=1e-4, atol=1e-4)
    for k in ("consensus_dist", "train_loss", "pre_dist", "push_force"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=1e-4, atol=1e-4)
    assert state.round == 1 and state.t == tau


def _mlp_loss(params, batch):
    x = batch["x"]
    n = len(params)
    for i in range(n):
        x = x @ params[f"l{i}"]["w"] + params[f"l{i}"]["b"]
        if i < n - 1:
            x = torch.relu(x)
    lse = torch.logsumexp(x, dim=-1)
    picked = torch.gather(x, -1, batch["y"][:, None])[:, 0]
    loss = torch.mean(lse - picked)
    return loss, {"loss": loss}


def test_quickstart_width_matches_reference():
    """README quickstart: run_distributed's setup at M=4, 300 steps (75
    rounds) through the port's trainer, fast flat engine on both sides.
    The MLP's initial weights and the data come from the same numpy."""
    M, steps, bs, lr = 4, 300, 64, 0.05
    jdata = default_data()
    dkw = dict(alpha=0.1, lam=0.5, tau=4, engine="flat")
    want = run_distributed(jdata, JDPPFConfig(**dkw), M=M, steps=steps)

    data = classification_task(device="cpu")
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]))
    p0 = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0),
                                           data["dim"], data["n_classes"]))

    def init(gen, device):
        return {l: {k: torch.tensor(v, device=device) for k, v in d.items()}
                for l, d in p0.items()}

    dcfg = DPPFConfig(**dkw)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    state = init_train_state(init, opt, dcfg, M, None, device="cpu")
    clock = RoundClock.from_config(dcfg, base_lr=lr, total_steps=steps)
    step = make_round_step(_mlp_loss, opt, dcfg, clock=clock)
    shards = worker_shards(len(data["x_train"]), M, 0)
    rng = np.random.default_rng(1)
    for spec in clock.rounds:
        b = round_batches(data, shards, rng, spec.tau, M, bs)
        state, _ = step(state, {
            "x": torch.tensor(np.asarray(b["x"])),
            "y": torch.from_numpy(np.asarray(b["y"]).astype(np.int64))})
    width = float(state.engine.dists_to_mean(state.params).mean())
    assert abs(width - want.consensus_dist) < 1e-3, (width,
                                                     want.consensus_dist)


def test_launcher_smoke_on_cpu():
    from repro_torch.launch.train import main
    loss = main(["--arch", "yi-6b", "--smoke", "--workers", "4", "--tau",
                 "4", "--steps", "8", "--seq", "16", "--batch", "2"],
                device="cpu")
    assert np.isfinite(loss)


@pytest.mark.parametrize("flags", [["--elastic-drop", "2,3,5"],
                                   ["--mesh", "2,2,2"], ["--sharded"],
                                   ["--autotune"]])
def test_launcher_refuses_unported_paths(flags, capsys):
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit):
        main(["--smoke", *flags], device="cpu")
    assert "not yet ported" in capsys.readouterr().err


def test_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("kw, steps", [
    (dict(tau=4), 30),
    (dict(tau=3, lam_schedule="decreasing", qsr_beta=0.4), 64),
    (dict(tau=4, consensus="entropy_sgd"), 18),
    (dict(tau=5, lam_schedule="fixed"), 5),
])
def test_round_clock_matches_reference(kw, steps):
    jc = JRoundClock.from_config(JDPPFConfig(**kw), base_lr=0.3,
                                 total_steps=steps, warmup=2)
    pc = RoundClock.from_config(DPPFConfig(**kw), base_lr=0.3,
                                total_steps=steps, warmup=2)
    assert [(r.index, r.start, r.tau, r.scope) for r in pc.rounds] \
        == [(r.index, r.start, r.tau, r.scope) for r in jc.rounds]
    assert (pc.total_rounds, pc.fixed_rounds) \
        == (jc.total_rounds, jc.fixed_rounds)
    for i in range(pc.total_rounds):
        assert pc.lam_at(i) == pytest.approx(float(jc.lam_at(i)), abs=1e-7)
        assert pc.pull_scale_at(i) == float(jc.pull_scale_at(i))
    for t in range(steps):
        assert pc.lr_at(t) == pytest.approx(float(jc.lr_at(t)), abs=1e-7)
        assert pc.round_of_step(t) == jc.round_of_step(t)


@pytest.mark.parametrize("kw, steps, warmup", [
    (dict(tau=4), 32, 0),                                     # fixed
    (dict(tau=5, lam_schedule="decreasing"), 23, 3),          # remainder
    (dict(tau=4, tau_schedule="qsr", qsr_beta=0.4), 64, 0),   # QSR
    (dict(tau=4, consensus="entropy_sgd"), 18, 0),            # inner plan
])
def test_round_clock_report_matches_reference(kw, steps, warmup):
    """``describe()`` and ``plan_table()`` (full and elided) string-equal
    to the reference's."""
    jc = JRoundClock.from_config(JDPPFConfig(**kw), base_lr=0.3,
                                 total_steps=steps, warmup=warmup)
    pc = RoundClock.from_config(DPPFConfig(**kw), base_lr=0.3,
                                total_steps=steps, warmup=warmup)
    assert repr(pc.describe()) == repr(jc.describe())
    for rows in (12, 6):
        assert pc.plan_table(max_rows=rows) == jc.plan_table(max_rows=rows)


@pytest.mark.parametrize("method, optimizer, sam_rho", [
    ("mgrawa", "sgd", 0.05), ("lpf_sgd", "adamw", 0.0),
    ("easgd", "sgd", 0.0),
])
def test_mlp_rounds_match_reference(method, optimizer, sam_rho):
    """Two rounds of the benchmark MLP through both trainers (fast flat
    engine on both sides): the optimizers, SAM, the loss / grad-norm
    plumbing into the lowering and LPF-SGD's filtered push."""
    from benchmarks.common import mlp_loss
    M, tau, bs, steps = 4, 2, 16, 4
    data = classification_task(device="cpu")
    jp0 = mlp_init(jax.random.PRNGKey(1), data["dim"], data["n_classes"], 16)
    p0 = jax.tree.map(np.asarray, jp0)
    dkw = dict(alpha=0.2, lam=0.3, tau=tau, engine="flat", consensus=method,
               lam_schedule="fixed")
    jd, pd = JDPPFConfig(**dkw), DPPFConfig(**dkw)
    okw = dict(momentum=0.9, weight_decay=1e-3)
    jopt = jmake_optimizer(optimizer, **okw)
    opt = make_optimizer(optimizer, **okw)
    jstate = jinit_train_state(lambda k: jp0, jopt, jd, M,
                               jax.random.PRNGKey(0))
    state = init_train_state(
        lambda gen, device: {l: {k: torch.tensor(v) for k, v in d.items()}
                             for l, d in p0.items()},
        opt, pd, M, None, device="cpu")
    jclock = JRoundClock.from_config(jd, base_lr=0.05, total_steps=steps)
    clock = RoundClock.from_config(pd, base_lr=0.05, total_steps=steps)
    jstep = jax.jit(jmake_round_step(mlp_loss, jopt, jd, clock=jclock,
                                     sam_rho=sam_rho))
    step = make_round_step(_mlp_loss, opt, pd, clock=clock, sam_rho=sam_rho)
    shards = worker_shards(len(data["x_train"]), M, 0)
    rng = np.random.default_rng(2)
    for spec in clock.rounds:
        b = round_batches(data, shards, rng, spec.tau, M, bs)
        x, y = np.asarray(b["x"]), np.asarray(b["y"])
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x),
                                    "y": jnp.asarray(y, jnp.int32)})
        state, m = step(state, {"x": torch.tensor(x),
                                "y": torch.tensor(y, dtype=torch.int64)})
        for k in ("consensus_dist", "train_loss", "pull_force"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(jstate.params), rtol=1e-4,
                               atol=1e-4)
