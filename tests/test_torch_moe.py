"""The port's MoE MLP (``repro_torch/models/moe.py``) and the two MoE
families (reduced dbrx-132b: 4 experts, top-2; reduced
llama4-scout-17b-a16e: top-1 and a shared expert) against the JAX package
on the same numpy inputs, on the CPU: ``moe_mlp``'s output, aux loss and
gradients, capacity drops, top-k ties, the decode grouping, and the LM's
logits, loss, gradients and flat layout (the bodies of
``tests/test_torch_model.py``)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_model as tm
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro_torch.configs import get_arch, reduced
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import moe
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)

MOE = ("dbrx-132b", "llama4-scout-17b-a16e")
ATOL = 1e-4


def _moe_params(name, seed=0, **over):
    """(reference cfg, port cfg, reference params, port params) of one
    reduced MoE layer."""
    jcfg = jreduced(jget_arch(name), **over)
    cfg = reduced(get_arch(name), **over)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = {k: (torch.tensor(np.asarray(v)) if not isinstance(v, dict) else
             {kk: torch.tensor(np.asarray(vv)) for kk, vv in v.items()})
         for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("S", [16, 1])
def test_moe_mlp_matches_reference(name, S):
    """Output and aux at S = 16 (a group per row) and S = 1 (a decode
    step: one group over the batch of 3), and the gradients of a weighted
    sum of the output plus the aux loss with respect to every weight and
    the input."""
    jcfg, cfg, jp, p = _moe_params(name)
    x = _x(cfg, 3, S)
    wt = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jout, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    out, aux = moe.moe_mlp(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    assert aux.dtype == torch.float32

    def jf(pp, xx):
        o, a = jmoe.moe_mlp(pp, xx, jcfg)
        return jnp.sum(o * wt) + a
    jg, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [v.requires_grad_(True) for v in jax.tree_util.tree_leaves(p)]
    xt = torch.from_numpy(x).requires_grad_(True)
    o, a = moe.moe_mlp(p, xt, cfg)
    grads = torch.autograd.grad((o * torch.from_numpy(wt)).sum() + a,
                                leaves + [xt])
    want = jax.tree_util.tree_leaves(jg) + [jgx]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=ATOL)


def test_moe_capacity_drops_tokens_when_tight():
    """The reference's tight-capacity case (capacity factor 0.25, 64
    tokens): dropped tokens give zero rows, the same rows as the
    reference's, and the outputs agree."""
    jcfg, cfg, jp, p = _moe_params("dbrx-132b", capacity_factor=0.25)
    x = _x(cfg, 1, 64)
    jout, _ = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    out, _ = moe.moe_mlp(p, torch.from_numpy(x), cfg)
    zero = np.linalg.norm(out[0].numpy(), axis=-1) < 1e-6
    jzero = np.linalg.norm(np.asarray(jout)[0], axis=-1) < 1e-6
    assert zero.sum() > 0
    np.testing.assert_array_equal(zero, jzero)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    assert moe._capacity(64, cfg) == jmoe._capacity(64, jcfg) == 8


@pytest.mark.parametrize("name", MOE)
def test_moe_zero_router_ties_go_to_the_lower_index(name):
    """A zeroed router makes every probability tie: ``jax.lax.top_k``
    takes the lowest expert indices, so every token's first choice is
    expert 0, load = (1, 0, ...), importance uniform and aux exactly 1;
    the port breaks the ties the same way (its output equals the
    reference's, which routes every token to experts 0..k-1)."""
    jcfg, cfg, jp, p = _moe_params(name)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x(cfg, 2, 32)
    jout, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    out, aux = moe.moe_mlp(p, torch.from_numpy(x), cfg)
    assert float(jaux) == float(aux) == 1.0
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    vals, ids = moe._top_k(torch.full((2, 5, cfg.n_experts), 0.25),
                           cfg.top_k)
    assert ids.tolist() == [[list(range(cfg.top_k))] * 5] * 2


def test_decode_capacity_depends_on_the_batch():
    """A decode step groups over the batch (S == 1), so its capacity is
    C = max(int(B k / E cf), k), B the batch: both packages give the same
    C for every group size, at reduced dbrx with the published factor
    1.25 and at the full config (an 8160-token prefill row: 2550; a
    decode step over 4 sequences: 4)."""
    jcfg = jreduced(jget_arch("dbrx-132b"), capacity_factor=1.25)
    cfg = reduced(get_arch("dbrx-132b"), capacity_factor=1.25)
    for tokens in (1, 4, 8, 32, 8160):
        assert moe._capacity(tokens, cfg) == jmoe._capacity(tokens, jcfg)
    full = get_arch("dbrx-132b")
    assert moe._capacity(8160, full) == 2550
    assert moe._capacity(4, full) == 4


def test_chunked_prefill_differs_from_one_shot_under_drops():
    """A fault of the reference (ROADMAP.md Queue 3): a prefill chunk is
    its own routing group, so when tokens drop (the published capacity
    factor 1.25) feeding a prompt chunk by chunk does not reproduce the
    one-shot prefill. Reduced dbrx at 1.25, a 32-token prompt: one shot
    has C = 20 a row, chunks of 8 have C = 5. Each lane of the port
    matches the same lane of the reference to 1e-4; the two lanes differ
    in both packages by the same amount."""
    over = dict(capacity_factor=1.25)
    jcfg = jreduced(jget_arch("dbrx-132b"), **over)
    cfg = reduced(get_arch("dbrx-132b"), **over)
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                           buf_len=32)
    lg, _ = model.prefill(params, {"tokens": tokens}, 32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    js, _ = jmodel.make_state(jparams, {"tokens": tokens}, 32)
    st, _ = model.make_state(params, {"tokens": tokens}, 32)
    for j in range(0, 32, 8):
        jc, js = jmodel.prefill_chunk(jparams, js,
                                      jnp.asarray(tokens[:, j:j + 8]), j)
        c, st = model.prefill_chunk(params, st, tokens[:, j:j + 8], j)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    gap = float(np.abs(np.asarray(jc) - np.asarray(jl)).max())
    assert gap > 1e-2, gap
    np.testing.assert_allclose(float((c - lg).abs().max()), gap, rtol=1e-3)


@pytest.mark.parametrize("arch", MOE)
def test_logits_and_loss_match_reference(arch):
    tm.test_logits_and_loss_match_reference(arch)


@pytest.mark.parametrize("arch", MOE)
def test_loss_gradient_matches_reference(arch):
    tm.test_loss_gradient_matches_reference(arch)


@pytest.mark.parametrize("arch", MOE)
def test_flat_layout_matches_reference(arch):
    tm.test_flat_layout_matches_reference(arch)


def test_aux_is_summed_over_layers_and_through_remat():
    """``run_blocks`` carries the sum of the layers' aux losses, as the
    reference's scan does (at 3 layers), and the remat path passes it
    through the checkpoint with the same value and gradients."""
    from repro.models import transformer as jlm
    from repro_torch.core.engine import tree_from_items, tree_items
    from repro_torch.models import transformer as lm
    jcfg, cfg = tm._configs("dbrx-132b@3")
    jparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    _, jaux = jlm.lm_logits(jcfg, jparams, jnp.asarray(tokens, jnp.int32))
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        items = [(path, l.detach().requires_grad_(True))
                 for path, l in tree_items(params)]
        leaves = [l for _, l in items]
        _, aux = lm.lm_logits(c, tree_from_items(items),
                              torch.from_numpy(tokens))
        out[remat] = (float(aux.detach()),
                      torch.autograd.grad(aux, leaves, allow_unused=True))
    np.testing.assert_allclose(out[False][0], float(jaux), rtol=0, atol=1e-6)
    assert out[True][0] == out[False][0]
    for a, b in zip(out[False][1], out[True][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
