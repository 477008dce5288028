"""The port's ConsensusEngine and flat consensus lowering against the JAX
package, mode for mode (kernel, fast, precise) on the same numpy inputs.

The kernel mode runs the reference's Pallas kernel in interpret mode and
the port's plain version (CPU tensors). The port's fast path is never held
against the reference's tree path: the reference's own fast flat engine
differs from its tree engine at 1e-4 (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DPPFConfig as JDPPFConfig
from repro.core import consensus as jcons
from repro.core import methods as jmethods
from repro.core.engine import ConsensusEngine as JEngine
from repro_torch.configs import DPPFConfig
from repro_torch.core import consensus, methods
from repro_torch.core.engine import ConsensusEngine
from repro_torch.models import flat_from_numpy

MODES = ("kernel", "fast", "precise")
TOL = dict(atol=5e-4, rtol=1e-4)      # tests/test_engine.py fp32 parity
METHODS = methods.method_names(aliases=False)


def _stacked(M=4, seed=7):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(M, 33, 7)).astype(np.float32),
            "b": rng.normal(size=(M, 17)).astype(np.float32),
            "s": rng.normal(size=(M, 5, 3, 2)).astype(np.float32)}


def _engines(stacked, mode, method="simple_avg"):
    kw = dict(use_kernel=mode == "kernel", precise=mode == "precise")
    j = JEngine.from_stacked({k: jnp.asarray(v) for k, v in stacked.items()},
                             method=method, interpret=True, **kw)
    p = ConsensusEngine.from_stacked(
        {k: torch.from_numpy(v) for k, v in stacked.items()},
        method=method, **kw)
    return j, p


def test_registry_matches_reference():
    assert methods.method_names() == jmethods.method_names()
    assert methods.tree_method_names() == jmethods.tree_method_names()
    for name in methods.method_names():
        a, b = methods.get_method(name), jmethods.get_method(name)
        for f in ("name", "needs_losses", "needs_grad_norms", "hard_pull",
                  "pull_ramp", "leader", "aux_rows", "aux_pull",
                  "center_beta", "pushes", "fuse_eq5", "push_source",
                  "filter_mu", "inner_rounds", "inner_pull",
                  "requires_flat", "communicates"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert (a.weight_fn is None) == (b.weight_fn is None)


def test_flatten_matches_reference_column_for_column():
    stacked = _stacked()
    j, p = _engines(stacked, "fast", method="easgd")
    want = np.asarray(j.flatten({k: jnp.asarray(v)
                                 for k, v in stacked.items()}))
    got = p.flatten({k: torch.from_numpy(v) for k, v in stacked.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert p.layout.n == j.layout.n and p.layout.R == j.layout.R
    back = p.unflatten(got)
    for k, v in stacked.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize("mode", MODES)
def test_stage_matches_reference(mode):
    stacked = _stacked()
    j, p = _engines(stacked, mode)
    flat = np.asarray(j.flatten({k: jnp.asarray(v)
                                 for k, v in stacked.items()}))
    R = flat.shape[0]
    rng = np.random.default_rng(3)
    z = np.exp(rng.normal(size=(R, R)))
    T = (z / z.sum(1, keepdims=True)).astype(np.float32)
    c0 = np.linspace(0.1, 0.4, R, dtype=np.float32)
    c1 = np.linspace(-0.5, -0.2, R, dtype=np.float32)
    want = j.stage(jnp.asarray(flat), jnp.asarray(T), jnp.asarray(c0),
                   jnp.asarray(c1))
    got = p.stage(flat_from_numpy(p.layout, flat, device="cpu"),
                  torch.from_numpy(T), torch.from_numpy(c0),
                  torch.from_numpy(c1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _round_inputs(M, n, seed=11):
    rng = np.random.default_rng(seed)
    return dict(losses=np.asarray([3.0, 1.0, 2.0, 4.0], np.float32)[:M],
                grad_norms=np.asarray([1.0, 2.0, 0.5, 1.0], np.float32)[:M],
                push_vec=rng.normal(size=(M, n)).astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
def test_apply_round_matches_reference(method, mode):
    stacked = _stacked()
    j, p = _engines(stacked, mode, method)
    flat = np.asarray(j.flatten({k: jnp.asarray(v)
                                 for k, v in stacked.items()}))
    M, n = j.layout.M, j.layout.n
    ins = _round_inputs(M, n)
    kw = dict(alpha=0.3, lam=0.4, consensus=method, engine="flat")
    jcfg, pcfg = JDPPFConfig(**kw), DPPFConfig(**kw)
    needs_vec = methods.get_method(method).push_source == "filtered_grad"
    j_new, _, j_m = jcons.apply_round(
        jnp.asarray(flat), jcfg, 0.25, {}, losses=jnp.asarray(ins["losses"]),
        grad_norms=jnp.asarray(ins["grad_norms"]), engine=j,
        push_vec=jnp.asarray(ins["push_vec"]) if needs_vec else None)
    p_new, _, p_m = consensus.apply_round(
        flat_from_numpy(p.layout, flat, device="cpu"), pcfg, 0.25, {},
        losses=torch.from_numpy(ins["losses"]),
        grad_norms=torch.from_numpy(ins["grad_norms"]), engine=p,
        push_vec=torch.from_numpy(ins["push_vec"]) if needs_vec else None)
    np.testing.assert_allclose(p_new.numpy(), np.asarray(j_new), **TOL)
    assert set(p_m) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(float(p_m[k]), float(j_m[k]), **TOL)


@pytest.mark.parametrize("method", ["simple_avg", "easgd", "lsgd", "mgrawa"])
def test_masked_lowering_matches_reference(method):
    """Elastic participation mask: an inactive row passes through the
    stages (up to the gap form's rounding, tx + 1 * (x - tx)), and the
    rest mix as in the reference."""
    stacked = _stacked()
    j, p = _engines(stacked, "precise", method)
    flat = np.asarray(j.flatten({k: jnp.asarray(v)
                                 for k, v in stacked.items()}))
    ins = _round_inputs(j.layout.M, j.layout.n)
    mask = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    kw = dict(alpha=0.3, lam=0.4, consensus=method, engine="flat")
    j_new, _, _ = jcons.apply_round(
        jnp.asarray(flat), JDPPFConfig(**kw), 0.25, {},
        losses=jnp.asarray(ins["losses"]),
        grad_norms=jnp.asarray(ins["grad_norms"]), engine=j,
        mask=jnp.asarray(mask))
    p_new, _, _ = consensus.apply_round(
        flat_from_numpy(p.layout, flat, device="cpu"), DPPFConfig(**kw),
        0.25, {}, losses=torch.from_numpy(ins["losses"]),
        grad_norms=torch.from_numpy(ins["grad_norms"]), engine=p,
        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(p_new.numpy(), np.asarray(j_new), **TOL)
    np.testing.assert_allclose(p_new.numpy()[1], flat[1], rtol=0, atol=1e-6)


def test_exact_second_term_matches_reference():
    stacked = _stacked()
    j, p = _engines(stacked, "fast")
    flat = np.asarray(j.flatten({k: jnp.asarray(v)
                                 for k, v in stacked.items()}))
    kw = dict(alpha=0.3, lam=0.4, engine="flat", exact_second_term=True)
    j_new, _, j_m = jcons.apply_round(jnp.asarray(flat), JDPPFConfig(**kw),
                                      0.25, {}, engine=j)
    p_new, _, p_m = consensus.apply_round(
        flat_from_numpy(p.layout, flat, device="cpu"), DPPFConfig(**kw),
        0.25, {}, engine=p)
    np.testing.assert_allclose(p_new.numpy(), np.asarray(j_new), **TOL)
    np.testing.assert_allclose(float(p_m["consensus_dist"]),
                               float(j_m["consensus_dist"]), **TOL)


def test_kernel_mode_is_in_place_and_default_off_the_card():
    stacked = _stacked()
    _, p = _engines(stacked, "kernel")
    flat = p.flatten({k: torch.from_numpy(v) for k, v in stacked.items()})
    R = p.layout.R
    T = torch.full((R, R), 1.0 / R)
    new, _, _, _ = p.stage(flat, T, torch.full((R,), 0.1),
                           torch.full((R,), -0.4))
    assert new.data_ptr() == flat.data_ptr()
    default = ConsensusEngine.from_stacked(
        {k: torch.from_numpy(v) for k, v in stacked.items()})
    assert not default.use_kernel and default.device == "cpu"


def test_tree_path_is_not_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        consensus.apply_round({}, DPPFConfig(), 0.1, {})
