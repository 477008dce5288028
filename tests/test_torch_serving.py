"""The port's serving path against the JAX package, on the CPU: reduced
yi-6b, gemma2-2b, zamba2-7b (6 layers, and 9 with the remainder blocks)
and xlstm-350m (4 and 8 layers on the per-step mLSTM of the published
config, and with ``xlstm_chunk = 16``) in fp32 with the reference's
initial weights carried across. Prefill / chunked prefill / decode logits and model states under
teacher forcing, greedy ``generate`` tokens, the SlotEngine against the
port's own ``generate`` (continuous and ring), the committed serving
trace's step counts, sampling units and the decode_key contract, the
ValueError surface, the launcher, and the kernel route of the prefill."""
from __future__ import annotations

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.serving import generate as jgenerate
from repro.serving.sampling import (
    SamplingParams as JSamplingParams, mask_logits as jmask_logits,
)
from repro_torch.configs import get_arch, reduced
from repro_torch.core.engine import tree_items
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.models import (
    build_model, params_from_numpy, states_from_numpy,
)
from repro_torch.models import attention as attn
from repro_torch.models import transformer as lm
from repro_torch.serving import (
    GREEDY, Request, SamplingParams, Scheduler, SlotEngine, decode_key,
    decode_loop_cache_size, generate, sample_token, serve,
)
from repro_torch.serving.sampling import (
    NEG_INF, fold_in, mask_logits, sample_batch,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# "name@L": the reduced config cut to L layers; "/chunkN": xlstm_chunk N
ARCHS = ("yi-6b", "gemma2-2b", "zamba2-7b", "zamba2-7b@9", "xlstm-350m",
         "xlstm-350m@8", "xlstm-350m/chunk16")
ATOL = 1e-4
# the streaming modes: (buf_len, window, chunk, prompt length)
MODES = {"full": (32, 0, 8, 20), "ring": (19, 16, 4, 24)}


def _overrides(arch):
    """'name[@L][/chunkN]' -> (name, reduced() overrides)."""
    arch, _, chunk = arch.partition("/chunk")
    name, _, layers = arch.partition("@")
    kw = {"n_layers": int(layers)} if layers else {}
    if chunk:
        kw["xlstm_chunk"] = int(chunk)
    return name, kw


@functools.lru_cache(maxsize=None)
def _mp(arch):
    """(reference model, reference params, cfg, model, params) per arch."""
    name, kw = _overrides(arch)
    jmodel = jbuild_model(jreduced(jget_arch(name), **kw))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = reduced(get_arch(name), **kw)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, cfg, build_model(cfg), params


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (l,)) for l in lens]


def _requests(cfg, lens, news, seed=0):
    return [Request(rid=i, tokens=t, max_new_tokens=n)
            for i, (t, n) in enumerate(zip(_prompts(cfg, lens, seed), news))]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jpaths(jtree):
    """{path: leaf} of a reference tree, in the port's path entries (a dict
    key, or a tuple element's index)."""
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}


FRESH_M = -1e30     # an xLSTM stabiliser before its first token


def _same_states(states, jstates):
    """Leaf by leaf, over nested state trees. An xLSTM state leaf (a tuple
    element: its path ends in an index) is held to ATOL times its scale,
    taken over its live entries: the m stabiliser grows by about the
    forget-gate bias every step (to about 100 after 20 tokens), so fp32
    forms f + m - m' from numbers of that size and the accumulated c and
    n (scale up to about 10) differ from the reference's by up to 3e-5 of
    their scale. A stabiliser entry that is still fresh (-1e30, no token
    seen) must be fresh in both, exactly."""
    got = dict(tree_items(states))
    want = _jpaths(jstates)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        g, w = _np(leaf), np.asarray(want[path])
        tol = ATOL
        if isinstance(path[-1], int):
            fresh = w == np.float32(FRESH_M)
            np.testing.assert_array_equal(g == np.float32(FRESH_M), fresh,
                                          err_msg=f"{path}: fresh entries")
            g, w = g[~fresh], w[~fresh]
            if w.size:
                tol = ATOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# model lanes against the reference, teacher-forced
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_chunks_and_decode_match_reference(arch, mode):
    """One-shot prefill (full mode), chunk-by-chunk streaming and decode
    steps fed the same tokens: logits within 1e-4 and the KV caches leaf
    by leaf."""
    jmodel, jparams, cfg, model, params = _mp(arch)
    buf, window, chunk, S = MODES[mode]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    follow = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)

    if S <= buf:
        jl, js = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                buf_len=buf, window=window)
        lg, st = model.prefill(params, {"tokens": tokens}, buf, window=window)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        _same_states(st, js)

    jchunk = jax.jit(lambda p, s, t, i: jmodel.prefill_chunk(
        p, s, t, i, window=window))
    js, jstart = jmodel.make_state(jparams, {"tokens": tokens}, buf,
                                   window=window)
    st, start = model.make_state(params, {"tokens": tokens}, buf,
                                 window=window)
    assert start == int(jstart) == 0
    _same_states(st, js)
    for j in range(0, S, chunk):
        jl, js = jchunk(jparams, js, jnp.asarray(tokens[:, j:j + chunk]),
                        jnp.int32(j))
        lg, st = model.prefill_chunk(params, st, tokens[:, j:j + chunk], j,
                                     window=window)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"chunk at {j}")
    _same_states(st, js)

    jstep = jax.jit(lambda p, s, t, i: jmodel.decode_step(
        p, s, t, i, window=window))
    for i in range(follow.shape[1]):
        jl, js = jstep(jparams, js, jnp.asarray(follow[:, i:i + 1]),
                       jnp.int32(S + i))
        lg, st = model.decode_step(params, st, follow[:, i:i + 1], S + i,
                                   window=window)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"decode {i}")
    _same_states(st, js)


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


def test_states_from_numpy_carries_nested_hybrid_states():
    """zamba2-7b's cycle / remainder tree (KV caches per shared-attention
    occurrence, Mamba ssm and conv states) carried across after a prefill
    continues as the reference does."""
    jmodel, jparams, cfg, model, params = _mp("zamba2-7b@9")
    tokens = np.arange(14, dtype=np.int32).reshape(2, 7)
    _, js = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                           buf_len=16)
    np_states = jax.tree.map(np.asarray, js)
    st = states_from_numpy(cfg, np_states, device="cpu")
    _same_states(st, js)
    assert st["cycle"]["b5"]["pos"].dtype == torch.int32
    assert st["remainder"]["b0"]["ssm"].dtype == torch.float32
    jl, _ = jmodel.decode_step(jparams, js, jnp.asarray([[3], [4]]), 7)
    lg, _ = model.decode_step(params, st, np.asarray([[3], [4]]), 7)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    bad = jax.tree.map(lambda a: a, np_states)
    del bad["remainder"]["b2"]
    with pytest.raises(ValueError, match="missing"):
        states_from_numpy(cfg, bad, device="cpu")


def test_states_from_numpy_carries_xlstm_state_tuples():
    """xlstm's state tree has no KV cache: ``states_from_numpy`` reads the
    batch from its first leaf. The (C, n, m) and (c, n, h, m) tuples carried
    across after a prefill continue as the reference does."""
    jmodel, jparams, cfg, model, params = _mp("xlstm-350m@8")
    tokens = np.arange(21, dtype=np.int32).reshape(3, 7)
    _, js = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                           buf_len=16)
    np_states = jax.tree.map(np.asarray, js)
    st = states_from_numpy(cfg, np_states, device="cpu")
    _same_states(st, js)
    assert isinstance(st["cycle"]["b3"], tuple) and len(st["cycle"]["b3"]) == 4
    assert st["cycle"]["b0"][0].shape == (2, 3, 4, 128, 128)
    assert all(t.dtype == torch.float32 for _, t in tree_items(st))
    follow = np.asarray([[3], [4], [5]])
    jl, _ = jmodel.decode_step(jparams, js, jnp.asarray(follow), 7)
    lg, _ = model.decode_step(params, st, follow, 7)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    bad = dict(np_states, cycle=dict(np_states["cycle"]))
    bad["cycle"]["b3"] = bad["cycle"]["b3"][:3]
    with pytest.raises(ValueError, match="missing"):
        states_from_numpy(cfg, bad, device="cpu")


def test_slot_insert_copies_fresh_xlstm_states():
    """A slot that held a running request takes a fresh request state
    whole: n = 1e-6 and m = -1e30 where the fresh state has them, nothing
    zeroed; the blank slot table holds the same fresh values."""
    _, _, cfg, model, params = _mp("xlstm-350m")
    engine = SlotEngine(model, params, max_slots=2, buf_len=32, chunk=4)
    slots = engine.blank_slots()
    fresh = {p: t.clone() for p, t in tree_items(engine.request_state(
        {"tokens": np.zeros((1, 1), np.int32)})[0])}
    for path, leaf in tree_items(slots["model"]):
        for s in range(2):
            assert torch.equal(leaf[s], fresh[path]), path
    f32 = lambda v: float(np.float32(v))
    assert float(fresh[("cycle", "b3", 1)].min()) == f32(1e-6)
    assert float(fresh[("cycle", "b3", 3)].max()) == f32(-1e30)
    assert float(fresh[("cycle", "b0", 2)].max()) == f32(-1e30)
    # run a request in slot 1, then admit a fresh one over it
    state, _ = engine.request_state({"tokens": np.zeros((1, 1), np.int32)})
    state, idx, tail = engine.prefill_chunks(state, np.arange(1, 10), 0)
    slots = engine.insert(slots, state, 1, idx, -(len(tail) - 1), 4, 0)
    engine.decode(slots, np.asarray([0, tail[0]]))
    assert not torch.equal(slots["model"]["cycle"]["b3"][3][1],
                           fresh[("cycle", "b3", 3)])
    new, _ = engine.request_state({"tokens": np.zeros((1, 1), np.int32)})
    slots = engine.insert(slots, new, 1, 0, 0, 4, 0)
    for path, leaf in tree_items(slots["model"]):
        assert torch.equal(leaf[1], fresh[path]), path


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


# ---------------------------------------------------------------------------
# the kernel route of the prefill
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# generate and the slot engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_greedy_equals_reference(arch, mode):
    jmodel, jparams, cfg, model, params = _mp(arch)
    buf, window, chunk, S = MODES[mode]
    tokens = np.stack(_prompts(cfg, [S, S], seed=6)).astype(np.int32)
    want, jlogits = jgenerate(jmodel, jparams, {"tokens": jnp.asarray(tokens)},
                              max_new_tokens=6, buf_len=buf, window=window,
                              chunk=chunk)
    got, logits = generate(model, params, {"tokens": tokens},
                           max_new_tokens=6, buf_len=buf, window=window,
                           chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_matches_generate_and_lanes_stay_at_one(arch):
    """Mixed-length requests admitted and evicted mid-decode give exactly
    the tokens of per-request generate() (greedy), and a second,
    differently mixed stream leaves every lane at one signature."""
    _, _, cfg, model, params = _mp(arch)
    engine = SlotEngine(model, params, max_slots=2, buf_len=32, chunk=4)
    lens, news = [5, 11, 3], [6, 4, 5]
    reqs = _requests(cfg, lens, news)
    report = serve(engine, reqs)
    assert sorted(report.results) == [0, 1, 2]
    assert report.generated == sum(news)
    for req in reqs:
        want, _ = generate(model, params, {"tokens": req.tokens[None]},
                           max_new_tokens=req.max_new_tokens, buf_len=32)
        assert report.results[req.rid].tokens == want[0].tolist(), \
            f"{arch}: rid {req.rid} diverged from generate()"
    sizes = engine.compile_cache_sizes()
    assert sizes == {"fresh": 1, "chunk": 1, "decode": 1, "insert": 1}, sizes
    serve(engine, _requests(cfg, [9, 2, 6], [3, 5, 2], seed=1))
    assert engine.compile_cache_sizes() == sizes


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_wraparound_matches_generate(arch):
    """Prompts longer than buf_len stream through the ring (window mode);
    decode continues past the wrap point."""
    _, _, cfg, model, params = _mp(arch)
    window, chunk, buf = 16, 4, 19     # buf == window + chunk - 1 exactly
    engine = SlotEngine(model, params, max_slots=2, buf_len=buf,
                        window=window, chunk=chunk)
    reqs = _requests(cfg, [24, 20], [8, 8])
    report = serve(engine, reqs)
    for req in reqs:
        want, _ = generate(model, params, {"tokens": req.tokens[None]},
                           max_new_tokens=8, buf_len=buf, window=window,
                           chunk=chunk)
        assert report.results[req.rid].tokens == want[0].tolist(), \
            f"{arch}: ring-wraparound rid {req.rid} diverged"


def test_generate_decode_loop_keeps_one_signature():
    _, _, cfg, model, params = _mp("yi-6b")
    batch = {"tokens": _prompts(cfg, [10], seed=3)[0][None]}
    t1, _ = generate(model, params, batch, max_new_tokens=7, buf_len=24)
    t2, _ = generate(model, params, batch, max_new_tokens=7, buf_len=24)
    assert torch.equal(t1, t2)
    assert decode_loop_cache_size(model, 7, 0) == 1
    # a different prompt length shares the loop's signature
    generate(model, params, {"tokens": _prompts(cfg, [14], seed=4)[0][None]},
             max_new_tokens=7, buf_len=24)
    assert decode_loop_cache_size(model, 7, 0) == 1


def test_committed_trace_step_counts():
    """BENCH_serving.json's trace: reduced gemma2-2b, 4 slots, buf_len 64,
    chunk 8. The step counts are structural: continuous 41, static 60, and
    both modes give the same greedy tokens."""
    from benchmarks.bench_serving import CHUNK, MAX_SLOTS, TRACE_LENS, \
        TRACE_NEW
    bench = json.loads((ROOT / "BENCH_serving.json").read_text())["serving"]
    _, _, cfg, model, params = _mp("gemma2-2b")
    buf = max(TRACE_LENS) + max(TRACE_NEW)
    assert (buf, MAX_SLOTS, CHUNK) == (64, 4, 8) == (
        bench["buf_len"], bench["max_slots"], bench["chunk"])
    engine = SlotEngine(model, params, max_slots=MAX_SLOTS, buf_len=buf,
                        chunk=CHUNK)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, (l,)),
                    max_new_tokens=n)
            for i, (l, n) in enumerate(zip(TRACE_LENS, TRACE_NEW))]
    cont = serve(engine, reqs, mode="continuous")
    stat = serve(engine, reqs, mode="static")
    assert (cont.steps, stat.steps) == (41, 60) == (
        bench["continuous"]["steps"], bench["static"]["steps"])
    assert cont.generated == stat.generated == sum(TRACE_NEW)
    assert cont.occupancy > stat.occupancy
    for rid in range(len(reqs)):
        assert cont.results[rid].tokens == stat.results[rid].tokens


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(temperature=0.7), dict(top_k=5), dict(top_p=0.9),
    dict(temperature=1.3, top_k=12, top_p=0.8), dict(top_k=100),
    dict(top_p=1e-6), dict(), dict(temperature=0.0)], ids=str)
def test_mask_logits_equals_reference(kw):
    logits = np.random.default_rng(11).normal(
        scale=3.0, size=(3, 50)).astype(np.float32)
    want = np.asarray(jmask_logits(jnp.asarray(logits), JSamplingParams(**kw)))
    got = mask_logits(torch.from_numpy(logits), SamplingParams(**kw)).numpy()
    np.testing.assert_array_equal(got > NEG_INF / 2, want > NEG_INF / 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_mask_logits_units():
    logits = torch.tensor([0.1, 3.0, -1.0, 2.0, 0.5, -2.0])
    kept = torch.nonzero(mask_logits(logits, SamplingParams(top_k=2))
                         > NEG_INF / 2).flatten().tolist()
    assert kept == [1, 3]
    nucleus = torch.tensor([10.0, 1.0, 0.0, -1.0])
    out = mask_logits(nucleus, SamplingParams(top_p=1e-6))
    assert torch.nonzero(out > NEG_INF / 2).flatten().tolist() == [0]
    # greedy and the no-op params return the input itself
    assert mask_logits(logits, GREEDY) is logits
    assert mask_logits(logits, SamplingParams()) is logits


def test_sample_batch_and_token_contract():
    logits = torch.tensor([[0.0, 0.0, 0.0, 5.0]]).repeat(3, 1)
    keys = [fold_in(9, i) for i in range(3)]
    toks = sample_batch(logits, keys, SamplingParams(temperature=1e-3))
    assert toks.tolist() == [3, 3, 3] and toks.dtype == torch.int64
    assert sample_batch(logits, keys, GREEDY).tolist() == [3, 3, 3]
    flat = torch.zeros(1000)
    sp = SamplingParams()
    draws = [int(sample_token(flat, fold_in(5, i), sp)) for i in range(6)]
    assert len(set(draws)) > 1                     # keys decide the draw
    assert draws == [int(sample_token(flat, fold_in(5, i), sp))
                     for i in range(6)]            # and reproducibly
    assert decode_key(7, 0) == 7 and decode_key(7, 3) == fold_in(7, 3) != 7


def test_sampled_stream_reproducible_and_slot_independent():
    """Per-request keys are derived from rid, so sampled outputs are a
    function of the request alone: same stream twice -> identical tokens,
    and submission order (slot placement, co-residents) is irrelevant."""
    _, _, cfg, model, params = _mp("yi-6b")
    sp = SamplingParams(temperature=0.8, top_k=8)
    engine = SlotEngine(model, params, max_slots=2, buf_len=48, chunk=4,
                        sampling=sp)
    lens, news = [7, 5, 9], [6, 6, 6]
    a = serve(engine, _requests(cfg, lens, news), key=5)
    b = serve(engine, _requests(cfg, lens, news), key=5)
    c = serve(engine, list(reversed(_requests(cfg, lens, news))), key=5)
    d = serve(engine, _requests(cfg, lens, news), key=6)
    for rid in range(3):
        assert a.results[rid].tokens == b.results[rid].tokens
        assert a.results[rid].tokens == c.results[rid].tokens, \
            f"rid {rid}: tokens depend on submission order"
    assert any(a.results[r].tokens != d.results[r].tokens for r in range(3))


def test_engine_sampling_follows_decode_key_contract():
    """Manual replay: generated token 0 is sampled with the request key
    itself, token i >= 1 with fold_in(key, i), however the prompt was
    chunked into the slot."""
    _, _, cfg, model, params = _mp("yi-6b")
    sp = SamplingParams(temperature=0.8, top_k=8)
    engine = SlotEngine(model, params, max_slots=1, buf_len=32, chunk=4,
                        sampling=sp)
    prompt = _prompts(cfg, [6])[0]
    rkey = fold_in(7, 0)
    report = serve(engine, [Request(rid=0, tokens=prompt, max_new_tokens=5)],
                   key=7)
    logits, states = model.prefill(params, {"tokens": prompt[None]}, 32)
    tok = int(sample_token(logits[0], decode_key(rkey, 0), sp))
    want = [tok]
    for i in range(1, 5):
        lg, states = model.decode_step(params, states, [[tok]],
                                       prompt.size + i - 1)
        tok = int(sample_token(lg[0], decode_key(rkey, i), sp))
        want.append(tok)
    assert report.results[0].tokens == want


# ---------------------------------------------------------------------------
# ValueError surface (tests/test_serving.py's, for the ported families)
# ---------------------------------------------------------------------------

def test_sampling_params_validation():
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)


def test_generate_validation():
    _, _, cfg, model, params = _mp("yi-6b")
    batch = {"tokens": np.zeros((1, 6), np.int32)}
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(model, params, batch, max_new_tokens=0, buf_len=16)
    with pytest.raises(ValueError, match="window"):
        generate(model, params, batch, max_new_tokens=2, buf_len=8, window=9)
    with pytest.raises(ValueError, match="silently truncate"):
        generate(model, params, {"tokens": np.zeros((1, 20), np.int32)},
                 max_new_tokens=2, buf_len=16)


def test_slot_engine_validation():
    _, _, cfg, model, params = _mp("yi-6b")
    for kw in (dict(max_slots=0, buf_len=8), dict(max_slots=1, buf_len=0),
               dict(max_slots=1, buf_len=8, window=-1),
               dict(max_slots=1, buf_len=8, window=9),
               # chunk write would clobber live ring slots
               dict(max_slots=1, buf_len=16, window=16, chunk=8)):
        with pytest.raises(ValueError):
            SlotEngine(model, params, **kw)
    # enc-dec models (which need an example batch) are not ported yet
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(reduced(get_arch("seamless-m4t-medium")))

    engine = SlotEngine(model, params, max_slots=2, buf_len=16)
    slots = engine.blank_slots()
    state, start = engine.request_state({"tokens": np.asarray([[0]])})
    with pytest.raises(ValueError, match="slot"):
        engine.insert(slots, state, 2, 0, 0, 4, 0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.insert(slots, state, 0, 0, 0, 0, 0)
    with pytest.raises(ValueError, match="empty prompt"):
        engine.prefill_chunks(state, np.zeros((0,), np.int64), start)


def test_scheduler_and_request_validation():
    _, _, cfg, model, params = _mp("yi-6b")
    with pytest.raises(ValueError, match="max_slots"):
        Scheduler(0)
    with pytest.raises(ValueError, match="mode"):
        Scheduler(1, mode="adaptive")
    with pytest.raises(ValueError, match="empty prompt"):
        Request(rid=0, tokens=np.zeros((0,)), max_new_tokens=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(rid=0, tokens=np.ones((3,)), max_new_tokens=0)
    engine = SlotEngine(model, params, max_slots=1, buf_len=16)
    with pytest.raises(ValueError, match="buf_len"):
        Scheduler(1).submit(Request(rid=0, tokens=np.ones((10,), np.int64),
                                    max_new_tokens=10), engine)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_launcher_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main
    report = main(["--smoke", "--requests", "5", "--max-slots", "2",
                   "--prompt-len", "12", "--new-tokens", "4", "--chunk",
                   "4"], device="cpu")
    assert sorted(report.results) == list(range(5))
    assert all(len(r.tokens) == 4 for r in report.results.values())
    assert report.steps > 0 and 0 < report.occupancy <= 1
    assert "lane signatures {'fresh': 1, 'chunk': 1, 'decode': 1, " \
        "'insert': 1}" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(["--smoke", "--ckpt", "x.npz"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--smoke"])


def test_serve_launcher_serves_zamba2_on_cpu():
    from repro_torch.launch.serve import main
    report = main(["--arch", "zamba2-7b", "--smoke", "--requests", "4",
                   "--max-slots", "2", "--prompt-len", "12", "--new-tokens",
                   "3", "--chunk", "4"], device="cpu")
    assert sorted(report.results) == list(range(4))
    assert all(len(r.tokens) == 3 for r in report.results.values())


def test_serve_launcher_serves_xlstm_on_cpu():
    """xlstm-350m as the reference's launcher runs it: the published
    config (``xlstm_chunk = 0``, per-step mLSTM), no new flag."""
    from repro_torch.launch.serve import main
    report = main(["--arch", "xlstm-350m", "--smoke", "--requests", "4",
                   "--max-slots", "2", "--prompt-len", "12", "--new-tokens",
                   "3", "--chunk", "4"], device="cpu")
    assert sorted(report.results) == list(range(4))
    assert all(len(r.tokens) == 3 for r in report.results.values())


def test_slot_engine_is_freed_without_the_cycle_collector():
    """No reference cycle runs through the engine's lanes: dropping the
    last reference frees it (and with it a model's worth of parameters)
    at once, not at the cycle collector's next pass."""
    import gc
    import weakref
    _, _, cfg, model, params = _mp("yi-6b")
    engine = SlotEngine(model, params, max_slots=2, buf_len=16, chunk=4)
    serve(engine, _requests(cfg, [5, 3], [2, 2]))
    ref = weakref.ref(engine)
    gc.disable()
    try:
        del engine
        assert ref() is None
    finally:
        gc.enable()


def test_slot_reset_zeroes_mamba_states():
    """Inserting a fresh request state into a used slot writes every leaf
    of the nested tree: the slot's SSM and conv states come back zero, its
    KV caches blank (pos -1), and the other slot is untouched."""
    _, _, cfg, model, params = _mp("zamba2-7b")
    engine = SlotEngine(model, params, max_slots=2, buf_len=16, chunk=4)
    slots = engine.blank_slots()
    state, start = engine.request_state({"tokens": np.zeros((1, 1))})
    state, idx, tail = engine.prefill_chunks(state, np.arange(9), start)
    for slot in (0, 1):
        slots = engine.insert(slots, state, slot, idx, 0, 4, 0)
    used = {path: leaf.clone() for path, leaf in tree_items(slots["model"])}
    assert bool(used[("cycle", "b0", "ssm")][0].any())
    assert bool(used[("cycle", "b0", "conv")][0].any())
    fresh, _ = engine.request_state({"tokens": np.zeros((1, 1))})
    slots = engine.insert(slots, fresh, 0, 0, 0, 4, 0)
    for path, leaf in tree_items(slots["model"]):
        if path[-1] == "pos":
            assert bool((leaf[0] == -1).all()), path
        else:
            assert not bool(leaf[0].any()), path
        np.testing.assert_array_equal(leaf[1].numpy(), used[path][1].numpy())
