"""The port's dense transformer against the JAX package: the reference's
initial weights carried across as numpy, the same tokens, logits / loss /
gradients compared in fp32 on the CPU."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.core.engine import ConsensusEngine as JEngine
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import transformer as jlm
from repro_torch.configs import get_arch, reduced
from repro_torch.core.engine import (
    ConsensusEngine, tree_from_items, tree_items,
)
from repro_torch.models import attention as attn
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as lm

ARCHS = ("yi-6b", "gemma2-2b")
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _reference_params(arch, seed=0):
    """The reference's initial weights (jit: eager init is slow)."""
    jcfg = jreduced(jget_arch(arch))
    return jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(seed))


def _setup(arch, B=2, S=24, seed=0):
    jcfg = jreduced(jget_arch(arch))
    cfg = reduced(get_arch(arch))
    jparams = _reference_params(arch, seed)
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(cfg, np_params, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
             "labels": torch.from_numpy(labels.astype(np.int64))}
    return jcfg, cfg, jparams, params, jbatch, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_reference(arch):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(arch)
    j_logits, _ = jax.jit(functools.partial(jlm.lm_logits, jcfg))(
        jparams, jbatch["tokens"])
    j_loss, _ = jax.jit(functools.partial(jlm.lm_loss, jcfg))(jparams, jbatch)
    with torch.no_grad():
        logits, _ = lm.lm_logits(cfg, params, batch["tokens"])
        loss, metrics = build_model(cfg).loss(params, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0, atol=ATOL)
    assert set(metrics) == {"loss", "aux"}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_matches_reference(arch):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(arch)
    j_grads = jax.jit(jax.grad(lambda p: jlm.lm_loss(jcfg, p, jbatch)[0]))(
        jparams)
    leaves = [l.requires_grad_(True) for _, l in tree_items(params)]
    loss, _ = lm.lm_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for g, jg in zip(grads, j_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-3,
                                   atol=ATOL)


@pytest.mark.parametrize("window, cap", [(0, 0.0), (300, 50.0)])
def test_chunked_attention_matches_reference(window, cap):
    """Keys longer than one _CHUNK take the online-softmax path."""
    rng = np.random.default_rng(5)
    B, S, nq, nkv, hd = 1, 1100, 4, 2, 16
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32)
               for h in (nq, nkv, nkv))
    pos = np.arange(S, dtype=np.int32)
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                        window=window, cap=cap)
    got = attn.attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), q_pos=torch.from_numpy(pos),
                      kv_pos=torch.from_numpy(pos), window=window, cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_layout_matches_reference(arch):
    """The flat view of the same stacked params is column-for-column the
    reference's ConsensusEngine.flatten."""
    jcfg, cfg, jparams, params, _, _ = _setup(arch)
    M = 2
    jstacked = jax.tree.map(lambda a: jnp.stack([a, a * 0.5]), jparams)
    stacked = tree_from_items([(path, torch.stack([leaf, leaf * 0.5]))
                               for path, leaf in tree_items(params)])
    j = JEngine.from_stacked(jstacked)
    p = ConsensusEngine.from_stacked(stacked)
    np.testing.assert_array_equal(p.flatten(stacked).numpy(),
                                  np.asarray(j.flatten(jstacked)))
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert list(p.layout.paths) == paths
    assert p.layout.M == M


def test_params_from_numpy_checks_the_tree():
    cfg = reduced(get_arch("yi-6b"))
    np_params = jax.tree.map(np.asarray, _reference_params("yi-6b"))
    extra = dict(np_params, bogus=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(cfg, extra, device="cpu")
    missing = {k: v for k, v in np_params.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(cfg, missing, device="cpu")
    bad = dict(np_params, final_norm=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, bad, device="cpu")


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(reduced(get_arch("zamba2-7b")))
