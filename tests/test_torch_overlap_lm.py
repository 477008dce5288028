"""The port's overlapped rounds on ``reduced(yi-6b)`` against the JAX
package: the params and batches come from the reference as numpy; the
kernel mode runs the port's kernel wrappers (their plain versions on CPU
tensors) against the reference's Pallas kernels in interpret mode, the
precise mode against the precise mode. rtol = atol = 1e-4 on params and
metrics (as ``tests/test_torch_round.py``). The fast mode runs on the MLP
only (``tests/test_torch_overlap.py``): here its uncentered Gram meets the
collapsed fleet of round 0 at its noise floor (the reference's documented
deviation), and the two packages' plain fast round already differs by
1.2e-4 in 2 of 5,772,288 entries, before any overlap."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DPPFConfig as JDPPFConfig
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.core.engine import ConsensusEngine as JEngine
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import RoundClock as JRoundClock
from repro.train import init_train_state as jinit_train_state
from repro.train import make_round_step as jmake_round_step
from repro.train import set_participation as jset_participation
from repro_torch.configs import DPPFConfig, get_arch, reduced
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    RoundClock, init_train_state, make_round_step, set_participation,
)
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)


M, TAU, B, S = 4, 2, 2, 16
TOL = dict(rtol=1e-4, atol=1e-4)
CASES = {
    "kernel-doublebuf-c3": ("kernel", dict(overlap="doublebuf",
                                           overlap_chunks=3), 3),
    "kernel-elastic-k2": ("kernel", dict(overlap="staleness_k", staleness=2,
                                         elastic=True), 4),
    "precise-k3": ("precise", dict(overlap="staleness_k", staleness=3,
                                   overlap_chunks=2), 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_overlap_rounds_on_reduced_yi6b_match_reference(case):
    mode, over, rounds = CASES[case]
    jcfg, cfg = jreduced(jget_arch("yi-6b")), reduced(get_arch("yi-6b"))
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    dkw = dict(alpha=0.1, lam=0.5, tau=TAU, engine="flat",
               lam_schedule="fixed", **over)
    jd, pd = JDPPFConfig(**dkw), DPPFConfig(**dkw)
    jopt = jmake_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    jstacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (M,) + a.shape), jparams)
    ekw = {"kernel": dict(use_kernel=True, interpret=True,
                          block_cols=1 << 16),
           "precise": dict(use_kernel=False, precise=True)}[mode]
    jeng = JEngine.from_stacked(jstacked, eps=jd.eps, **ekw)
    jstate = jinit_train_state(lambda k: jparams, jopt, jd, M,
                               jax.random.PRNGKey(0), engine=jeng)
    steps = rounds * TAU
    jclock = JRoundClock.from_config(jd, base_lr=0.1, total_steps=steps)
    jstep = jax.jit(jmake_round_step(jmodel.loss, jopt, jd, clock=jclock))

    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    state = init_train_state(
        lambda gen, device: params_from_numpy(cfg, np_params, device=device),
        opt, pd, M, None, device="cpu")
    state.engine = dataclasses.replace(
        state.engine, use_kernel=mode == "kernel", precise=mode == "precise")
    clock = RoundClock.from_config(pd, base_lr=0.1, total_steps=steps)
    step = make_round_step(build_model(cfg).loss, opt, pd, clock=clock)

    rng = np.random.default_rng(0)
    for r in range(rounds):
        tokens = rng.integers(0, cfg.vocab_size, size=(TAU, M, B, S))
        labels = np.roll(tokens, -1, axis=-1)
        labels[..., -1] = -1
        if pd.elastic:
            mask = np.ones(M, np.float32)
            if r >= 1:
                mask[1] = 0.0          # out from round 1; forced back at 3
            jstate = jset_participation(jstate, jnp.asarray(mask))
            state = set_participation(state, torch.tensor(mask))
            before = state.params[1].clone()
        jstate, jm = jstep(jstate, {
            "tokens": jnp.asarray(tokens, jnp.int32),
            "labels": jnp.asarray(labels, jnp.int32)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens),
                                "labels": torch.from_numpy(labels)})
        what = f"{case} round {r}"
        np.testing.assert_allclose(state.params.numpy(),
                                   np.asarray(jstate.params), err_msg=what,
                                   **TOL)
        for k in ("consensus_dist", "train_loss", "pre_dist", "push_force"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=f"{what} {k}", **TOL)
        assert m["staleness"] == int(jm["staleness"])
        if pd.elastic and r in (1, 2):
            assert torch.equal(state.params[1], before), what
        if pd.elastic and r == 3:
            assert not torch.equal(state.params[1], before), what
            assert int(state.snap["missed"][1]) == 0
    assert state.round == rounds and state.t == steps
