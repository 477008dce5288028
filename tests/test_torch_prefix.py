"""The port's prefix path (vlm decoder-only: reduced internvl2-2b, 8
stubbed ViT patch embeddings before the tokens) against the JAX package on
the same numpy inputs, on the CPU: logits over the token positions, loss
and gradients; ``make_state`` running the prefix through the stack and
returning start P; prompt chunks after the prefix against the one-shot
prefill; ``generate`` with a prefix (decoding from S + P)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import transformer as jlm
from repro.serving import generate as jgenerate
from repro_torch.configs import get_arch, reduced
from repro_torch.core.engine import tree_from_items, tree_items
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as lm
from repro_torch.serving import generate
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)
from _torch_serving import _same_states

NAME = "internvl2-2b"
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _mp():
    """(reference model, reference params, cfg, model, params)."""
    jcfg, cfg = jreduced(jget_arch(NAME)), reduced(get_arch(NAME))
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, cfg, build_model(cfg), params


def _inputs(B=2, S=16, seed=0):
    cfg = _mp()[2]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    prefix = rng.normal(size=(B, cfg.n_prefix, cfg.d_model)).astype(
        np.float32)
    return tokens, labels, prefix


def test_logits_loss_and_gradients_match_reference():
    """Logits cover the S token positions only (the prefix is sliced off
    before the head); loss and every gradient, the prefix's too."""
    jmodel, jparams, cfg, model, params = _mp()
    tokens, labels, prefix = _inputs()
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "prefix": jnp.asarray(prefix)}
    jl, _ = jlm.lm_logits(jmodel.cfg, jparams, jb["tokens"], jb["prefix"])
    (jloss, _), (jg, jgp) = jax.jit(jax.value_and_grad(
        lambda p, x: jmodel.loss(p, dict(jb, prefix=x)), argnums=(0, 1),
        has_aux=True))(jparams, jb["prefix"])
    items = [(p, l.detach().clone().requires_grad_(True))
             for p, l in tree_items(params)]
    pre = torch.from_numpy(prefix).requires_grad_(True)
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
             "labels": torch.from_numpy(labels.astype(np.int64)),
             "prefix": pre}
    logits, _ = lm.lm_logits(cfg, tree_from_items(items), batch["tokens"],
                             pre)
    assert logits.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               rtol=0, atol=ATOL)
    loss, _ = model.loss(tree_from_items(items), batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0,
                               atol=ATOL)
    grads = torch.autograd.grad(loss, [l for _, l in items] + [pre])
    want = jax.tree_util.tree_leaves(jg) + [jgp]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=ATOL)


@pytest.mark.parametrize("chunk", [4, 16])
def test_make_state_runs_the_prefix_and_chunks_match_one_shot(chunk):
    """``make_state`` with a prefix fills its P cache positions and returns
    start P, as the reference's; the prompt then streams in chunks from
    P, and the last chunk's logits equal the one-shot prefill's (over
    prefix + prompt), in both packages."""
    jmodel, jparams, cfg, model, params = _mp()
    tokens, _, prefix = _inputs(seed=1)
    P, S, buf = cfg.n_prefix, tokens.shape[1], 40
    jb = {"tokens": jnp.asarray(tokens), "prefix": jnp.asarray(prefix)}
    b = {"tokens": tokens, "prefix": prefix}
    jone, jfull = jmodel.prefill(jparams, jb, buf_len=buf)
    one, full = model.prefill(params, b, buf)
    np.testing.assert_allclose(one.numpy(), np.asarray(jone), rtol=0,
                               atol=ATOL)
    _same_states(full, jfull)
    js, jstart = jmodel.make_state(jparams, jb, buf)
    st, start = model.make_state(params, b, buf)
    assert start == int(jstart) == P
    assert sorted(st["pos"][0].tolist())[-P:] == list(range(P))
    _same_states(st, js)
    for j in range(0, S, chunk):
        jl, js = jmodel.prefill_chunk(jparams, js,
                                      jnp.asarray(tokens[:, j:j + chunk]),
                                      P + j)
        lg, st = model.prefill_chunk(params, st, tokens[:, j:j + chunk],
                                     P + j)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), one.numpy(), rtol=0, atol=ATOL)
    _same_states(st, js)


def test_generate_with_a_prefix_matches_reference():
    """Greedy ``generate`` with a prefix: decoding starts at S + P (the
    buf_len check counts the prefix), tokens equal the reference's."""
    jmodel, jparams, cfg, model, params = _mp()
    tokens, _, prefix = _inputs(S=12, seed=2)
    buf = cfg.n_prefix + 12 + 6
    want, jlogits = jgenerate(
        jmodel, jparams, {"tokens": jnp.asarray(tokens),
                          "prefix": jnp.asarray(prefix)},
        max_new_tokens=6, buf_len=buf)
    got, logits = generate(model, params, {"tokens": tokens,
                                           "prefix": prefix},
                           max_new_tokens=6, buf_len=buf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match=r"\+8 prefix"):
        generate(model, params, {"tokens": tokens, "prefix": prefix},
                 max_new_tokens=2, buf_len=12 + 4)
