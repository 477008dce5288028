"""The port's serving path against the JAX package, on the CPU: reduced yi-6b
and gemma2-2b (the attention families). Helpers and the shared test bodies
are in ``tests/_torch_serving.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_serving import *  # noqa: F401,F403
import _torch_serving as ts

FAMILY = ('yi-6b', 'gemma2-2b')


@pytest.mark.parametrize("arch", FAMILY)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_chunks_and_decode_match_reference(arch, mode):
    ts.check_prefill_chunks_and_decode_match_reference(arch, mode)


@pytest.mark.parametrize("arch", FAMILY)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_greedy_equals_reference(arch, mode):
    ts.check_generate_greedy_equals_reference(arch, mode)


@pytest.mark.parametrize("arch", FAMILY)
def test_continuous_matches_generate_and_lanes_stay_at_one(arch):
    ts.check_continuous_matches_generate_and_lanes_stay_at_one(arch)


@pytest.mark.parametrize("arch", FAMILY)
def test_ring_wraparound_matches_generate(arch):
    ts.check_ring_wraparound_matches_generate(arch)


def test_states_from_numpy_carries_reference_caches():
    jmodel, jparams, cfg, model, params = _mp("gemma2-2b")
    tokens = np.arange(12, dtype=np.int32).reshape(2, 6)
    jl, js = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                            buf_len=16)
    st = states_from_numpy(cfg, jax.tree.map(np.asarray, js), device="cpu")
    assert st["pos"].dtype == torch.int32 and st["k"].dtype == torch.float32
    jl2, _ = jmodel.decode_step(jparams, js, jnp.asarray([[3], [4]]), 6)
    lg2, _ = model.decode_step(params, st, np.asarray([[3], [4]]), 6)
    np.testing.assert_allclose(lg2.numpy(), np.asarray(jl2), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="missing"):
        states_from_numpy(cfg, {"k": np.asarray(js["k"]),
                                "v": np.asarray(js["v"])}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        states_from_numpy(cfg, dict(jax.tree.map(np.asarray, js),
                                    pos=np.zeros((2, 7), np.int32)),
                          device="cpu")


def test_cache_update_chunk_wraps_around_ring_seam():
    """The reference's ring-seam setup, written in place by the port."""
    cache = attn.init_cache(1, 1, 8, 4, torch.float32, device="cpu")
    jcache = jattn.init_cache(1, 1, 8, 4, jnp.float32)
    k = np.arange(4 * 4, dtype=np.float32).reshape(1, 4, 1, 4)
    out = attn.cache_update(cache, torch.from_numpy(k),
                            torch.from_numpy(-k), 6)      # positions 6..9
    jout = jattn.cache_update(jcache, jnp.asarray(k), jnp.asarray(-k), 6)
    assert out is cache
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(jout[name]))
    np.testing.assert_array_equal(out["pos"].numpy(),
                                  [8, 9, -1, -1, -1, -1, 6, 7])
    # a one-token write at the seam and a write that exactly fills the ring
    one = attn.cache_update(cache, torch.ones(1, 1, 1, 4),
                            torch.ones(1, 1, 1, 4), 10)
    jone = jattn.cache_update(jout, jnp.ones((1, 1, 1, 4)),
                              jnp.ones((1, 1, 1, 4)), 10)
    full_k = np.arange(32, dtype=np.float32).reshape(1, 8, 1, 4)
    full = attn.cache_update(one, torch.from_numpy(full_k),
                             torch.from_numpy(full_k), 16)
    jfull = jattn.cache_update(jone, jnp.asarray(full_k),
                               jnp.asarray(full_k), 16)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(full[name].numpy(),
                                      np.asarray(jfull[name]))


def test_serving_kv_blocks_leave_attention_unchanged():
    """Attention over a serving cache takes larger kv blocks
    (``serve_block``); the online softmax over any block size equals the
    one-block softmax, with empty (pos -1) slots, a window and a cap."""
    assert attn.serve_block(4, 1, 8) == 1 << 20          # one block
    assert attn.serve_block(1, 512, 8) == 8192
    assert attn.serve_block(64, 8160, 8) == attn._CHUNK   # never below
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.normal(size=(2, 5, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 700, 2, 16)).astype(
        np.float32)) for _ in range(2))
    kv_pos = torch.arange(700, dtype=torch.int32)
    kv_pos[650:] = -1
    q_pos = torch.arange(600, 605, dtype=torch.int32)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=300, cap=30.0)
    one = attn.attend(q, k, v, block=1024, **kw)
    for block in (64, 256):
        np.testing.assert_allclose(attn.attend(q, k, v, block=block,
                                               **kw).numpy(),
                                   one.numpy(), rtol=0, atol=1e-6)


def test_cache_update_rejects_oversized_write():
    cache = attn.init_cache(1, 1, 4, 2, torch.float32, device="cpu")
    k = torch.zeros((1, 5, 1, 2))
    with pytest.raises(ValueError, match="buf_len"):
        attn.cache_update(cache, k, k, 0)


def test_prefill_at_index_zero_takes_the_kernel_route(monkeypatch):
    """At index 0 ``_self_attention`` calls ``swa_attention`` through
    ``ops.attention`` (once per layer of a prefill, never on a decode
    step), and that equals ``attend`` over the position-tagged cache."""
    _, _, cfg, model, params = _mp("gemma2-2b")
    calls = []
    real = swa_ops.attention

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)
    monkeypatch.setattr(swa_ops, "attention", spy)

    B, S, buf = 2, 12, 16
    rng = np.random.default_rng(8)
    p = {name: leaf[0] for name, leaf in params["blocks"]["stack"][
        "attn"].items()}
    window = lm._windows(cfg)[0]
    assert window == cfg.sliding_window      # a local layer: band + softcap
    h = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32))
    cache = attn.init_cache(B, cfg.n_kv_heads, buf, cfg.head_dim,
                            torch.float32, device="cpu")
    out, cache = lm._self_attention(p, h, cfg, window, cache, 0)
    assert calls == [dict(causal=True, window=window,
                          cap=cfg.attn_logit_softcap)]
    q, _, _ = attn.qkv_proj(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    pos = torch.arange(S, dtype=torch.int32)
    q = attn.rope(q, pos, cfg.rope_theta)
    want = attn.out_proj(p, attn.attend(
        q, cache["k"], cache["v"], q_pos=pos, kv_pos=cache["pos"],
        causal=True, window=window, cap=cfg.attn_logit_softcap))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-5)

    calls.clear()
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    _, st = model.prefill(params, {"tokens": tokens}, buf)
    assert len(calls) == cfg.n_layers
    calls.clear()
    model.decode_step(params, st, tokens[:, :1], S)
    st2, _ = model.make_state(params, {"tokens": tokens}, buf)
    model.prefill_chunk(params, st2, tokens[:, :4], 0)
    assert len(calls) == cfg.n_layers            # the first chunk only
    model.prefill_chunk(params, st2, tokens[:, 4:8], 4)
    assert len(calls) == cfg.n_layers
