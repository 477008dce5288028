"""Shared pieces of the port's serving tests
(``tests/test_torch_serving_*.py``, one file a model family, so that
``--dist loadfile`` spreads them over workers): the reference's and the port's models on the same initial
weights, prompts, state comparisons, and the bodies of the tests every
family runs (``check_*``, parametrised in each family's file)."""
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
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)

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


def check_prefill_chunks_and_decode_match_reference(arch, mode):
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


def check_generate_greedy_equals_reference(arch, mode):
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


def check_continuous_matches_generate_and_lanes_stay_at_one(arch):
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


def check_ring_wraparound_matches_generate(arch):
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


__all__ = ['_one_torch_thread', 'ARCHS', 'ATOL', 'FRESH_M', 'GREEDY', 'JSamplingParams', 'MODES', 'NEG_INF', 'ROOT', 'Request', 'SamplingParams', 'Scheduler', 'SlotEngine', '_jpaths', '_mp', '_np', '_overrides', '_prompts', '_requests', '_same_states', 'attn', 'build_model', 'check_continuous_matches_generate_and_lanes_stay_at_one', 'check_generate_greedy_equals_reference', 'check_prefill_chunks_and_decode_match_reference', 'check_ring_wraparound_matches_generate', 'decode_key', 'decode_loop_cache_size', 'fold_in', 'functools', 'generate', 'get_arch', 'jattn', 'jax', 'jbuild_model', 'jgenerate', 'jget_arch', 'jmask_logits', 'jnp', 'jreduced', 'json', 'lm', 'mask_logits', 'np', 'params_from_numpy', 'pathlib', 'pytest', 'reduced', 'sample_batch', 'sample_token', 'serve', 'states_from_numpy', 'swa_ops', 'torch', 'tree_items']
