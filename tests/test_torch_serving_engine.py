"""The port's serving path against the JAX package, on the CPU: the engine,
sampling, validation and the launcher (family-independent). Helpers and the
shared test bodies are in ``tests/_torch_serving.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_serving import *  # noqa: F401,F403
import _torch_serving as ts


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
    with pytest.raises(FileNotFoundError):     # --ckpt loads the file
        main(["--smoke", "--ckpt", "no-such-ckpt.npz"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--smoke"])


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
