"""The slot engine's batched decode step (``serving/engine.py::slot_step``:
one ``decode_step`` over all ``max_slots`` rows, as the reference's vmap
over slots) against its plain version, the per-slot loop
``slot_step_loop``, for every served family; and the slot table against
the reference's ``SlotEngine`` after the same admissions and steps. On
the CPU, at reduced sizes, one torch thread."""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)
from _torch_serving import MODES, _overrides, _same_states
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.serving import SlotEngine as JSlotEngine
from repro_torch.configs import get_arch, reduced
from repro_torch.core.engine import tree_items
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.registry import state_batch_axes
from repro_torch.serving import (
    GREEDY, Request, SamplingParams, SlotEngine, decode_key, serve,
)
from repro_torch.serving.engine import decode_keys, slot_step, slot_step_loop

# every served family; xlstm-350m in both mLSTM forms (the per-step
# recurrence and the chunkwise one, xlstm_chunk = 16)
FAMILIES = ("yi-6b", "gemma2-2b", "zamba2-7b", "xlstm-350m",
            "xlstm-350m/chunk16", "dbrx-132b", "llama4-scout-17b-a16e",
            "seamless-m4t-medium", "internvl2-2b")
SLOTS = 4
INACTIVE = 2             # the slot that holds a request but is not active
# prompt lengths a slot: the rows sit at different indices (the first at
# 0); in ring mode (buf_len 19) the longest prompt has wrapped the ring
LENS = {"full": (5, 12, 20, 28), "ring": (6, 17, 12, 22)}
STEPS = 4
TOL = 1e-5               # fp32: the same sums at batch 4 and at batch 1
SAMPLING = SamplingParams(temperature=0.8, top_k=40)
FRESH = -1e29            # below it: an xLSTM stabiliser that saw no token


@functools.lru_cache(maxsize=None)
def _port(arch):
    """(cfg, model, params): the reduced config, weights from a seed."""
    name, kw = _overrides(arch)
    cfg = reduced(get_arch(name), **kw)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


def _context(cfg, rng):
    """One request's stubbed frames or prefix (1, n_prefix, d_model)."""
    if not cfg.n_prefix:
        return {}
    return {"enc" if cfg.n_enc_layers else "prefix": rng.normal(
        size=(1, cfg.n_prefix, cfg.d_model)).astype(np.float32)}


def _engine(cls, cfg, model, params, mode, sampling):
    buf, window, chunk, _ = MODES[mode]
    example = {"tokens": np.zeros((1, 1), np.int32)}
    example.update({k: np.zeros_like(v) for k, v in
                    _context(cfg, np.random.default_rng(0)).items()})
    prefix = cfg.n_prefix if not cfg.n_enc_layers else 0
    return cls(model, params, max_slots=SLOTS, buf_len=buf + prefix,
               window=window, chunk=chunk, sampling=sampling,
               example=example)


def _admitted(engine, cfg, mode):
    """A slot table with a request in every slot (its own prompt and
    context, generated-token counters -1..2 so that both branches of the
    key contract are drawn), then slot INACTIVE switched off."""
    rng = np.random.default_rng(3)
    slots = engine.blank_slots()
    for s, n in enumerate(LENS[mode]):
        batch = dict({"tokens": np.zeros((1, 1), np.int32)},
                     **_context(cfg, rng))
        state, start = engine.request_state(batch)
        state, idx, _ = engine.prefill_chunks(
            state, rng.integers(0, cfg.vocab_size, n), start)
        slots = engine.insert(slots, state, s, idx, s - 1, 100, 1000 + s)
    slots["active"][INACTIVE] = False
    return slots


def _copy(engine, slots):
    """Another slot table holding the same numbers."""
    out = engine.blank_slots()
    for (_, dst), (_, src) in zip(tree_items(out["rows"]),
                                  tree_items(slots["rows"])):
        dst.copy_(src)
    for lane in ("index", "gen", "budget", "key", "active"):
        out[lane] = slots[lane].clone()
    return out


def _rows_close(got, want, what):
    """Logits rows within TOL of each row's scale (at least 1): xLSTM's
    logits, of scale ~1.3, differ by up to 8e-6 between batch 4 and
    batch 1 for the reason ``_close`` gives; the other families' by up
    to 2e-6."""
    scale = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    assert np.all(np.abs(got - want) <= TOL * scale), \
        f"{what}: max abs err {np.abs(got - want).max():.3e}"


def _close(got, want, what):
    """Leaf by leaf within TOL; an xLSTM state leaf (a tuple element, its
    path ends in an index) within TOL of its scale over the entries that
    saw a token: its stabiliser m grows by about the forget-gate bias
    every token (to about 80 here), and c and n follow exp(f + m - m'),
    so a rounding at batch 4 that differs from the one at batch 1 moves
    them by a few ulps of that scale."""
    want = dict(tree_items(want))
    for path, leaf in tree_items(got):
        g, w = leaf.numpy(), want[path].numpy()
        tol = TOL
        if isinstance(path[-1], int):
            seen = np.abs(w[w > FRESH])
            tol = TOL * max(1.0, float(seen.max()) if seen.size else 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_batched_step_matches_the_per_slot_loop(arch, mode):
    """STEPS teacher-forced steps of a 4-slot table (rows at different
    indices, one inactive) through ``slot_step`` and, on a copy, through
    ``slot_step_loop``: the active rows' logits and every state leaf
    within TOL (of their scale, where ``_rows_close`` and ``_close`` say
    why), the sampled tokens (temperature 0.8, top-k 40) equal,
    the lanes equal, and the inactive row's state bit-identical to what
    it held before."""
    cfg, model, params = _port(arch)
    engine = _engine(SlotEngine, cfg, model, params, mode, SAMPLING)
    slots = _admitted(engine, cfg, mode)
    assert len(set(slots["index"].tolist())) == SLOTS
    loop = _copy(engine, slots)
    frozen = {p: t.clone() for p, t in
              tree_items(engine.slot_state(slots, INACTIVE))}
    live = [s for s in range(SLOTS) if s != INACTIVE]
    rng = np.random.default_rng(7)
    for step in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, SLOTS)
        nxt, logits = slot_step(model, params, slots, toks, engine.window,
                                SAMPLING)
        want, want_logits = slot_step_loop(model, params, loop, toks,
                                           engine.window, SAMPLING)
        _rows_close(logits[live].numpy(), want_logits[live].numpy(),
                    f"{arch} step {step}")
        np.testing.assert_array_equal(nxt, want, err_msg=f"step {step}")
        assert nxt[INACTIVE] == 0
    for lane in ("index", "gen", "active"):
        assert torch.equal(slots[lane], loop[lane]), lane
    if mode == "ring":
        assert int(slots["index"].max()) > MODES[mode][0]
    _close(slots["rows"], loop["rows"], arch)
    for path, leaf in tree_items(engine.slot_state(slots, INACTIVE)):
        assert torch.equal(leaf, frozen[path]), path


def _both(name, mode, **over):
    """The reference's and the port's engines (greedy) over the same
    weights; ``over`` set in both packages' reduced configs."""
    jcfg = dataclasses.replace(jreduced(jget_arch(name)), **over)
    cfg = dataclasses.replace(reduced(get_arch(name)), **over)
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return (cfg, model, _engine(SlotEngine, cfg, model, params, mode, GREEDY),
            _engine(JSlotEngine, cfg, jmodel, jparams, mode, GREEDY))


@pytest.mark.parametrize("name,mode,over", [
    ("gemma2-2b", "ring", {}),
    ("seamless-m4t-medium", "full", {}),
    # top-1 of 4 experts at the published capacity factor: 4 slots routed
    # as one group get capacity 1, so two slots on one expert drop a token
    ("llama4-scout-17b-a16e", "full", {"capacity_factor": 1.25}),
], ids=["gemma2-ring", "seamless", "llama4-cap1.25"])
def test_slot_table_matches_the_reference_engine(name, mode, over,
                                                 monkeypatch):
    """Three requests admitted, steps, a fourth admitted mid-stream, more
    steps (budgets run out in between): the sampled tokens of the active
    slots equal the reference ``SlotEngine``'s, the lanes equal its lanes,
    and each slot's state read through ``slot_state`` matches the
    reference's slot within ATOL."""
    cfg, _, engine, jengine = _both(name, mode, **over)
    moe_inputs = []
    if cfg.n_experts:
        orig = moe_lib.moe_mlp

        def recorded(p, x, cfg_, per_row=False):
            if per_row:
                moe_inputs.append((p, x.clone()))
            return orig(p, x, cfg_, per_row=per_row)
        monkeypatch.setattr(moe_lib, "moe_mlp", recorded)
    rng = np.random.default_rng(5)
    slots, jslots = engine.blank_slots(), jengine.blank_slots()
    feed = np.zeros((SLOTS,), np.int64)
    tails, fed = {}, {}

    def admit(s, n, budget):
        nonlocal slots, jslots
        batch = dict({"tokens": np.zeros((1, 1), np.int32)},
                     **_context(cfg, rng))
        prompt = rng.integers(0, cfg.vocab_size, n)
        state, start = engine.request_state(batch)
        state, idx, tail = engine.prefill_chunks(state, prompt, start)
        jstate, jstart = jengine.request_state(batch)
        jstate, jidx, jtail = jengine.prefill_chunks(jstate, prompt, jstart)
        assert (start, idx, tail) == (jstart, jidx, jtail)
        slots = engine.insert(slots, state, s, idx, -(len(tail) - 1),
                              budget, s)
        jslots = jengine.insert(jslots, jstate, s, jidx, -(len(tail) - 1),
                                budget, jax.random.PRNGKey(s))
        tails[s], fed[s] = tail, 0
        feed[s] = tail[0]

    def steps(n):
        nonlocal slots, jslots
        for _ in range(n):
            act = slots["active"].clone()
            nxt, slots = engine.decode(slots, feed)
            jnxt, jslots = jengine.decode(jslots, feed.astype(np.int32))
            for s in range(SLOTS):
                if not act[s]:
                    assert nxt[s] == 0
                    continue
                assert nxt[s] == jnxt[s], f"slot {s}"
                fed[s] += 1
                feed[s] = (tails[s][fed[s]] if fed[s] < len(tails[s])
                           else nxt[s])

    for s, (n, budget) in enumerate(((7, 6), (13, 3), (10, 8))):
        admit(s, n, budget)
    steps(4)
    admit(3, 11, 5)
    steps(6)
    for lane in ("index", "gen", "active"):
        np.testing.assert_array_equal(slots[lane].numpy(),
                                      np.asarray(jslots[lane]), lane)
    assert not bool(slots["active"].all())      # a budget ran out
    for s in range(SLOTS):
        _same_states(engine.slot_state(slots, s),
                     jax.tree.map(lambda a: a[s], jslots["model"]))
    if cfg.n_experts:
        assert moe_inputs
        per_row = [int(moe_lib.dropped_entries(p, x, cfg, per_row=True))
                   for p, x in moe_inputs]
        one_group = [int(moe_lib.dropped_entries(p, x, cfg))
                     for p, x in moe_inputs]
        assert set(per_row) == {0}
        assert max(one_group) > 0, "no step would have dropped a token"


def test_decode_keys_follow_the_contract():
    """The vectorised key lanes equal ``decode_key`` slot by slot: the
    request key while gen <= 0, fold_in(key, gen) after."""
    keys = np.asarray([0, 7, 2 ** 62 + 5, 123456789, 42], np.int64)
    gen = np.asarray([-3, 0, 1, 17, 2 ** 20], np.int64)
    want = [decode_key(int(k), max(int(g), 0)) for k, g in zip(keys, gen)]
    assert decode_keys(keys, gen).tolist() == want


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m",
                                  "seamless-m4t-medium"])
def test_slot_table_layout(arch):
    """The table's states carry batch max_slots on each leaf's batch axis
    (a pos tag gains a row axis), every per-slot view lies in that storage,
    and an insert lands in its row: ``slot_state`` gives back the
    request's state, in its layout, and the other rows keep theirs."""
    cfg, model, params = _port(arch)
    engine = _engine(SlotEngine, cfg, model, params, "full", GREEDY)
    slots = engine.blank_slots()
    axes = state_batch_axes(cfg)
    blank = dict(tree_items(engine.request_state(
        dict({"tokens": np.zeros((1, 1), np.int32)},
             **_context(cfg, np.random.default_rng(0))))[0]))
    views = dict(tree_items(slots["model"]))
    for path, leaf in tree_items(slots["rows"]):
        ax = axes[path] if axes[path] is not None else leaf.dim() - 2
        assert leaf.shape[ax] == SLOTS and leaf.is_contiguous(), path
        assert views[path].shape == (SLOTS,) + blank[path].shape, path
        assert views[path].untyped_storage().data_ptr() == \
            leaf.untyped_storage().data_ptr(), path
    before = {p: t.clone() for p, t in tree_items(slots["rows"])}
    rng = np.random.default_rng(1)
    state, start = engine.request_state(
        dict({"tokens": np.zeros((1, 1), np.int32)}, **_context(cfg, rng)))
    state, idx, _ = engine.prefill_chunks(
        state, rng.integers(0, cfg.vocab_size, 12), start)
    slots = engine.insert(slots, state, 1, idx, 0, 4, 0)
    got = dict(tree_items(engine.slot_state(slots, 1)))
    for path, leaf in tree_items(state):
        assert torch.equal(got[path], leaf), path
    for path, leaf in tree_items(slots["model"]):
        for s in (0, 2, 3):
            assert torch.equal(leaf[s], before[path].movedim(
                axes[path] if axes[path] is not None
                else before[path].dim() - 2, 0)[s].reshape(
                    leaf[s].shape)), (path, s)


@pytest.mark.parametrize("arch", ["yi-6b", "xlstm-350m"])
def test_one_forward_per_decode_step(arch):
    """``serve`` calls ``decode_step`` once a decode step, however many
    slots are active, and the step's forward runs over all max_slots
    rows."""
    cfg, model, params = _port(arch)
    calls = []

    def counted(params, states, token, index, window=0, active=None):
        calls.append(tuple(token.shape))
        return model.decode_step(params, states, token, index,
                                 window=window, active=active)
    engine = SlotEngine(dataclasses.replace(model, decode_step=counted),
                        params, max_slots=3, buf_len=32, chunk=4)
    rng = np.random.default_rng(2)
    report = serve(engine, [Request(rid=i, tokens=rng.integers(
        0, cfg.vocab_size, n), max_new_tokens=m)
        for i, (n, m) in enumerate(((5, 4), (9, 2), (3, 6), (7, 3)))])
    assert len(calls) == report.steps > 0
    assert set(calls) == {(3, 1)}
    assert report.occupancy < 1.0     # steps with idle slots counted too


def test_per_row_cache_update_writes_one_slot_a_row():
    """A per-row write puts row b's token at slot index[b] % buf of its
    own row, tags it, wraps the ring, and leaves an inactive row (and
    every other slot) as it was."""
    gen = torch.Generator().manual_seed(0)
    B, buf = 3, 5
    cache = attn.init_cache(B, 2, buf, 4, torch.float32, device="cpu")
    cache["pos"] = torch.full((B, buf), -1, dtype=torch.int32)
    cache["k"].normal_(generator=gen)
    old = {k: v.clone() for k, v in cache.items()}
    k = torch.randn((B, 1, 2, 4), generator=gen)
    index = torch.tensor([3, 7, 9])
    active = torch.tensor([True, True, False])
    attn.cache_update(cache, k, -k, index, active)
    for b, (p, on) in enumerate(zip(index.tolist(), active.tolist())):
        for slot in range(buf):
            hit = on and slot == p % buf
            assert torch.equal(cache["k"][b, slot],
                               k[b, 0] if hit else old["k"][b, slot])
            assert torch.equal(cache["v"][b, slot],
                               -k[b, 0] if hit else old["v"][b, slot])
            assert int(cache["pos"][b, slot]) == (p if hit else -1)
    with pytest.raises(ValueError, match="one token a row"):
        attn.cache_update(cache, torch.zeros((B, 2, 2, 4)),
                          torch.zeros((B, 2, 2, 4)), index)
