"""Tensor-parallel serving (``models/parallel.py``) on spawned gloo ranks,
against the JAX package's single-device prefill and decode and against
the port's one-rank path, on reduced yi-6b, qwen2-72b (q / k / v biases),
gemma2-2b (tied embeddings, softcaps, a local window), dbrx-132b and
llama4-scout (experts over the ranks; a shared expert) on 2 ranks, and
gemma2-2b on 4, where its 2 KV heads are each held by two ranks.

Each rank builds its shard with ``launch.mesh.shard_params`` from the
reference's numpy weights (norms and biases perturbed, so that their
splits are exercised), runs the prefill and 4 decode steps that feed the
reference's greedy tokens, and ``generate`` (greedy, and through the ring
cache in chunks). Logits are held at ``ATOL`` (fp32; the ranks' partial
sums add in another order than one device's products) to the
reference's and at ``TP_ATOL`` to the port's one-rank logits; every rank
holds the same tokens, and each prefill issues the collectives the split
needs, no more. Without a ``model`` group, or with a group of one, the
model is the one-device model, bit for bit. All configs of a world size
run in one spawn (one torch thread a rank).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_tp
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import transformer as jlm
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import MeshPlan
from repro_torch.core.engine import tree_items
from repro_torch.launch import mesh as mm
from repro_torch.models import build_model, moe as moe_lib, params_from_numpy
from repro_torch.serving import SlotEngine, generate
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)

TWO = ("yi-6b", "qwen2-72b", "gemma2-2b", "dbrx-132b",
       "llama4-scout-17b-a16e")
FOUR = ("gemma2-2b",)
ATOL = 1e-4        # fp32 logits against the reference
TP_ATOL = 1e-5     # fp32 logits against the port's one-rank path
B, S, STEPS, BUF = 2, 12, 4, 32
RING = dict(buf_len=19, window=16, chunk=4)   # a 24-token prompt in chunks
RING_S = 24


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(numpy params, tokens, ring prompt, the reference's greedy tokens
    (B, STEPS + 1), its logits (B, STEPS + 1, V))."""
    jcfg = jreduced(jget_arch(arch))
    jparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    np_params = jax.tree.map(np.asarray, jparams)
    # norms and q / k / v biases start at zero: perturb every vector leaf
    for path, leaf in tree_items(np_params):
        if leaf.ndim <= 2 and path[-1] not in ("embed", "lm_head"):
            d = np_params
            for k in path[:-1]:
                d = d[k]
            d[path[-1]] = (leaf + 0.1 * rng.standard_normal(leaf.shape)
                           ).astype(leaf.dtype)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    ring = rng.integers(0, jcfg.vocab_size, (B, RING_S))
    prefill = jax.jit(functools.partial(jlm.lm_prefill, jcfg),
                      static_argnums=(2,))
    decode = jax.jit(functools.partial(jlm.lm_decode_step, jcfg))
    lg, states = prefill(jparams, jnp.asarray(tokens, jnp.int32), BUF)
    logits, toks = [lg], [jnp.argmax(lg, -1)]
    for i in range(STEPS):
        lg, states = decode(jparams, states, toks[-1][:, None].astype(
            jnp.int32), S + i)
        logits.append(lg)
        toks.append(jnp.argmax(lg, -1))
    return (np_params, torch.from_numpy(tokens), torch.from_numpy(ring),
            np.stack([np.asarray(t) for t in toks], 1),
            np.stack([np.asarray(l) for l in logits], 1))


@functools.lru_cache(maxsize=None)
def _one_rank(arch):
    """The port's one-device path on the case: (logits, tokens, ring
    tokens, ring logits, dropped entries at ``DROP_CF``)."""
    np_params, tokens, ring, jtoks, _ = _case(arch)
    cfg = reduced(get_arch(arch))
    model = build_model(cfg)
    params = params_from_numpy(cfg, np_params, device="cpu")
    logits, toks = _torch_tp.serve(model, params, tokens,
                                   torch.from_numpy(jtoks[:, :STEPS]), BUF)
    rtoks, rlogits = generate(model, params, {"tokens": ring},
                              max_new_tokens=STEPS, **RING)
    dropped = None
    if cfg.n_experts:
        dropped = int(moe_lib.dropped_entries(
            {"router": params["blocks"]["stack"]["moe"]["router"][0]},
            _torch_tp.drop_input(cfg),
            dataclasses.replace(cfg, capacity_factor=_torch_tp.DROP_CF)))
    return logits, toks, rtoks, rlogits, dropped


@functools.lru_cache(maxsize=None)
def _ranks(world):
    archs = TWO if world == 2 else FOUR
    cases = []
    for arch in archs:
        np_params, tokens, ring, jtoks, _ = _case(arch)
        cases.append((arch, np_params, tokens,
                      torch.from_numpy(jtoks[:, :STEPS]), BUF, ring, RING))
    return _torch_dist.spawn(_torch_tp.serve_cases, world, cases)


WORLDS = [(2, a) for a in TWO] + [(4, a) for a in FOUR]


@pytest.mark.parametrize("world, arch", WORLDS)
def test_tp_logits_match_the_reference(world, arch):
    jlogits = _case(arch)[4]
    for r, res in enumerate(_ranks(world)):
        got = res[arch]["logits"].numpy()
        np.testing.assert_allclose(got, jlogits, atol=ATOL, rtol=0,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("world, arch", WORLDS)
def test_tp_matches_the_one_rank_path(world, arch):
    logits, toks, rtoks, rlogits, dropped = _one_rank(arch)
    for r, res in enumerate(_ranks(world)):
        got = res[arch]
        torch.testing.assert_close(got["logits"], logits, atol=TP_ATOL,
                                   rtol=0, msg=f"rank {r}")
        torch.testing.assert_close(got["ring_logits"], rlogits,
                                   atol=TP_ATOL, rtol=0, msg=f"rank {r}")
        assert torch.equal(got["tokens"], toks)
        assert torch.equal(got["ring_tokens"], rtoks)
        assert got["dropped"] == dropped
    if dropped is not None:
        assert dropped > 0


@pytest.mark.parametrize("world, arch", WORLDS)
def test_tp_every_rank_holds_the_same_tokens(world, arch):
    res = _ranks(world)
    jtoks = _case(arch)[3]
    for got in res[1:]:
        assert torch.equal(got[arch]["tokens"], res[0][arch]["tokens"])
        assert torch.equal(got[arch]["ring_tokens"],
                           res[0][arch]["ring_tokens"])
    np.testing.assert_array_equal(res[0][arch]["tokens"].numpy(), jtoks)


@pytest.mark.parametrize("world, arch", WORLDS)
def test_tp_prefill_collectives(world, arch):
    """A prefill's collectives: the embedding's and the head's all-gather
    (a tied head's all-reduce instead), an all-reduce after each
    attention and each MLP (and a shared expert), a MoE layer's router
    all-gather; a rank holds max(nkv / world, 1) KV heads."""
    cfg = reduced(get_arch(arch))
    L = cfg.n_layers
    gathers = 1 + (0 if cfg.tie_embeddings else 1) + (L if cfg.n_experts
                                                      else 0)
    reduces = 2 * L + (L if cfg.shared_expert else 0) + \
        (1 if cfg.tie_embeddings else 0)
    D, V = cfg.d_model, cfg.vocab_size
    want_bytes = {"all-gather": 4 * (B * S * D + (0 if cfg.tie_embeddings
                                                  else B * V)
                                     + (L * B * S * cfg.n_experts
                                        if cfg.n_experts else 0)),
                  "all-reduce": 4 * ((reduces - (1 if cfg.tie_embeddings
                                                 else 0)) * B * S * D
                                     + (B * V if cfg.tie_embeddings else 0))}
    for res in _ranks(world):
        got = res[arch]
        assert got["collectives"] == {
            "all-gather": (gathers, want_bytes["all-gather"]),
            "all-reduce": (reduces, want_bytes["all-reduce"])}, arch
        assert got["kv_heads"] == max(cfg.n_kv_heads // world, 1)


@pytest.mark.parametrize("arch", ("yi-6b", "dbrx-132b"))
def test_generate_without_a_group_is_the_one_device_model(arch):
    """``build_model(cfg)``, ``build_model(cfg, None, None)`` and a mesh
    whose model group is one rank give the same model, and ``generate``
    the same bits: the unsharded path never reaches the sharded one."""
    np_params, tokens, ring, _, _ = _case(arch)
    cfg = reduced(get_arch(arch))
    params = params_from_numpy(cfg, np_params, device="cpu")
    one = mm.Mesh(mm.FLAT_AXES, (1, 1), device="cpu")
    assert mm.shard_params(cfg, params, one, MeshPlan()) is params
    outs = []
    for model in (build_model(cfg), build_model(cfg, None, None),
                  build_model(cfg, one, MeshPlan())):
        assert model.tp is None
        outs.append(generate(model, params, {"tokens": tokens},
                             max_new_tokens=STEPS, buf_len=BUF)
                    + generate(model, params, {"tokens": ring},
                               max_new_tokens=STEPS, **RING))
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)


def test_what_tp_serving_leaves_out():
    cfg = reduced(get_arch("yi-6b"))
    model = build_model(cfg, mm.VirtualMesh(mm.FLAT_AXES, (1, 2),
                                            device="cpu"), MeshPlan())
    params = model.init(None, "meta")
    with pytest.raises(NotImplementedError, match="slot engine"):
        SlotEngine(model, params, max_slots=2, buf_len=16)
    with pytest.raises(NotImplementedError, match="training"):
        model.loss(params, {})
