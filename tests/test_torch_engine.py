"""The port's ConsensusEngine and flat consensus lowering against the JAX
package, mode for mode (kernel, fast, precise) on the same numpy inputs.

The kernel mode runs the reference's Pallas kernel in interpret mode and
the port's plain version (CPU tensors). The port's fast path is never held
against the reference's tree path: the reference's own fast flat engine
differs from its tree engine at 1e-4 (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import jax
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
from repro_torch.core.engine import (
    ConsensusEngine, tree_at, tree_from_items, tree_items, tree_stack,
)
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
    """What stays unported beside the tree path is the overlap modes'
    precomputed Gram (``first_gram``); the tree path itself runs, and
    ``tests/test_torch_tree.py`` holds it against the reference."""
    stacked = {k: torch.from_numpy(v) for k, v in _stacked().items()}
    _, m = consensus.apply_round(stacked, DPPFConfig(), 0.1, {})[1:]
    assert set(m) == {"consensus_dist", "pre_dist", "pull_force",
                      "push_force"}
    _, p = _engines(_stacked(), "fast")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        consensus.apply_round(p.flatten(stacked), DPPFConfig(engine="flat"),
                              0.1, {}, engine=p,
                              first_gram=torch.zeros((4, 4)))


# ---------------------------------------------------------------------------
# tree helpers over dicts and tuples (the reference's state pytrees)
# ---------------------------------------------------------------------------

def _state_tree(seed):
    """A state tree shaped like xlstm's: dicts keyed out of order, tuples
    of leaves (an mLSTM (C, n, m) and an sLSTM (c, n, h, m) state)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"cycle": {"b3": (r(2, 3), r(2, 3) + 1, r(2, 3), r(2, 3) - 1),
                      "b0": (r(2, 3, 3), r(2, 3), r(2))},
            "a": {"k": r(4), "pos": np.arange(3, dtype=np.int32)}}


def _torch_tree(tree):
    return tree_from_items([(p, torch.from_numpy(leaf.copy()))
                            for p, leaf in tree_items(tree)])


def test_tree_items_follow_jax_order_and_round_trip_tuples():
    tree = _state_tree(0)
    items = tree_items(tree)
    jleaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in items] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jleaves]
    for (_, a), (_, b) in zip(items, jleaves):
        assert a is b
    assert items[2][0] == ("cycle", "b0", 0)
    back = tree_from_items(items)
    assert isinstance(back["cycle"]["b3"], tuple)
    assert len(back["cycle"]["b3"]) == 4
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    # a bare tuple tree, and a tuple nested in a tuple
    nested = (np.zeros(1), (np.ones(2), np.ones(3)))
    assert [p for p, _ in tree_items(nested)] == [(0,), (1, 0), (1, 1)]
    assert jax.tree_util.tree_structure(tree_from_items(
        tree_items(nested))) == jax.tree_util.tree_structure(nested)
    with pytest.raises(ValueError, match="tuple indices"):
        tree_from_items([((0,), 1), ((2,), 2)])


def test_tree_stack_and_tree_at_views_write_through():
    """``tree_at`` of a stacked tree gives views: an in-place write to a
    tuple leaf of the view (as a decode step writes an xLSTM state)
    reaches the stack, and the other rows stay."""
    trees = [_torch_tree(_state_tree(s)) for s in range(3)]
    stacked = tree_stack(trees)
    assert isinstance(stacked["cycle"]["b0"], tuple)
    assert stacked["cycle"]["b0"][0].shape == (3, 2, 3, 3)
    for i, t in enumerate(trees):
        view = tree_at(stacked, i)
        assert jax.tree_util.tree_structure(view) == \
            jax.tree_util.tree_structure(t)
        for (pa, a), (pb, b) in zip(tree_items(view), tree_items(t)):
            assert pa == pb and torch.equal(a, b)
    view = tree_at(stacked, 1)
    view["cycle"]["b3"][3].fill_(-1e30)
    view["cycle"]["b0"][0].add_(1.0)
    assert bool((stacked["cycle"]["b3"][3][1] == -1e30).all())
    assert torch.equal(stacked["cycle"]["b0"][0][1],
                       trees[1]["cycle"]["b0"][0] + 1.0)
    for i in (0, 2):
        assert torch.equal(stacked["cycle"]["b3"][3][i],
                           trees[i]["cycle"]["b3"][3])
