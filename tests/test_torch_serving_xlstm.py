"""The port's serving path against the JAX package, on the CPU: reduced
xlstm-350m at 4 layers, on the published per-step mLSTM and with
``xlstm_chunk = 16``. Helpers and the shared test bodies are in
``tests/_torch_serving.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_serving import *  # noqa: F401,F403
import _torch_serving as ts

FAMILY = ('xlstm-350m', 'xlstm-350m/chunk16')


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


def test_serve_launcher_serves_xlstm_on_cpu():
    """xlstm-350m as the reference's launcher runs it: the published
    config (``xlstm_chunk = 0``, per-step mLSTM), no new flag."""
    from repro_torch.launch.serve import main
    report = main(["--arch", "xlstm-350m", "--smoke", "--requests", "4",
                   "--max-slots", "2", "--prompt-len", "12", "--new-tokens",
                   "3", "--chunk", "4"], device="cpu")
    assert sorted(report.results) == list(range(4))
    assert all(len(r.tokens) == 3 for r in report.results.values())
