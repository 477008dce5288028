"""The port's serving path against the JAX package, on the CPU: reduced
seamless-m4t-medium (the encoder-decoder family; every batch and request
carries its own encoder frames). Helpers and the shared test bodies are
in ``tests/_torch_serving.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_serving import *  # noqa: F401,F403
import _torch_serving as ts

ARCH = "seamless-m4t-medium"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_greedy_equals_reference(mode):
    """generate on two prompts with their frames, one-shot (full) and
    streamed through the ring (ring): the reference's tokens and
    logits."""
    jmodel, jparams, cfg, model, params = _mp(ARCH)
    buf, window, chunk, S = MODES[mode]
    tokens = np.stack(_prompts(cfg, [S, S], seed=6)).astype(np.int32)
    enc = ts._context(cfg, 2, seed=7)["enc"]
    want, jlogits = jgenerate(jmodel, jparams,
                              {"tokens": jnp.asarray(tokens),
                               "enc": jnp.asarray(enc)},
                              max_new_tokens=6, buf_len=buf, window=window,
                              chunk=chunk)
    got, logits = generate(model, params, {"tokens": tokens, "enc": enc},
                           max_new_tokens=6, buf_len=buf, window=window,
                           chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=ATOL)


def test_continuous_matches_generate_and_reference():
    ts.check_serve_with_context_matches_generate_and_reference(ARCH)


def test_ring_wraparound_matches_generate():
    """Prompts longer than buf_len stream through the ring with their
    frames; decode continues past the wrap point."""
    _, _, cfg, model, params = _mp(ARCH)
    window, chunk, buf = 16, 4, 19
    enc = [ts._context(cfg, 1, seed=s)["enc"] for s in (1, 2)]
    engine = SlotEngine(model, params, max_slots=2, buf_len=buf,
                        window=window, chunk=chunk,
                        example={"tokens": np.zeros((1, 1), np.int32),
                                 "enc": np.zeros_like(enc[0])})
    prompts = _prompts(cfg, [24, 20])
    report = serve(engine, [Request(rid=i, tokens=t, max_new_tokens=8,
                                    enc=e[0])
                            for i, (t, e) in enumerate(zip(prompts, enc))])
    for i, (t, e) in enumerate(zip(prompts, enc)):
        want, _ = generate(model, params, {"tokens": t[None], "enc": e},
                           max_new_tokens=8, buf_len=buf, window=window,
                           chunk=chunk)
        assert report.results[i].tokens == want[0].tolist(), i


def test_slot_insert_carries_each_request_cross_kv():
    """Each slot holds its own request's cross k / v (computed once at
    admission); a reset rewrites the slot's frames and leaves the other
    slot alone."""
    _, _, cfg, model, params = _mp(ARCH)
    e0, e1 = (ts._context(cfg, 1, seed=s)["enc"] for s in (3, 4))
    engine = SlotEngine(model, params, max_slots=2, buf_len=16, chunk=4,
                        example={"tokens": np.zeros((1, 1), np.int32),
                                 "enc": np.zeros_like(e0)})
    slots = engine.blank_slots()
    for slot, e in ((0, e0), (1, e1)):
        st, start = engine.request_state({"tokens": np.zeros((1, 1)),
                                          "enc": e})
        slots = engine.insert(slots, st, slot, start, 0, 4, 0)
        want, _ = model.make_state(params, {"tokens": np.zeros((1, 1)),
                                            "enc": e}, 16)
        torch.testing.assert_close(slots["model"]["ck"][slot], want["ck"],
                                   rtol=0, atol=0)
    assert not torch.equal(slots["model"]["cv"][0], slots["model"]["cv"][1])
    keep = slots["model"]["ck"][1].clone()
    st, _ = engine.request_state({"tokens": np.zeros((1, 1)), "enc": e1})
    slots = engine.insert(slots, st, 0, 0, 0, 4, 0)
    torch.testing.assert_close(slots["model"]["ck"][0], keep, rtol=0, atol=0)
    torch.testing.assert_close(slots["model"]["ck"][1], keep, rtol=0, atol=0)


def test_serve_launcher_serves_encdec_on_cpu(capsys):
    """The launcher draws each request's frames and hands the engine an
    example batch with the frames' shape; the cache counts no frame
    positions."""
    from repro_torch.launch.serve import build_requests, main
    report = main(["--arch", ARCH, "--smoke", "--requests", "4",
                   "--max-slots", "2", "--prompt-len", "12", "--new-tokens",
                   "3", "--chunk", "4"], device="cpu")
    assert sorted(report.results) == list(range(4))
    assert all(len(r.tokens) == 3 for r in report.results.values())
    assert "buf=27 " in capsys.readouterr().out
    cfg = reduced(get_arch(ARCH))
    reqs = build_requests(cfg, 5, [3, 4], 2)
    assert all(r.enc.shape == (cfg.n_prefix, cfg.d_model) and
               r.prefix is None for r in reqs)
    assert not np.array_equal(reqs[0].enc, reqs[1].enc)
    np.testing.assert_array_equal(build_requests(cfg, 5, [3], 2)[0].enc,
                                  reqs[0].enc)
