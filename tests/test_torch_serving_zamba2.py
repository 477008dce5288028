"""The port's serving path against the JAX package, on the CPU: reduced
zamba2-7b at 6 layers and at 9 (with the remainder blocks). Helpers and the
shared test bodies are in ``tests/_torch_serving.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_serving import *  # noqa: F401,F403
import _torch_serving as ts

FAMILY = ('zamba2-7b', 'zamba2-7b@9')


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


def test_serve_launcher_serves_zamba2_on_cpu():
    from repro_torch.launch.serve import main
    report = main(["--arch", "zamba2-7b", "--smoke", "--requests", "4",
                   "--max-slots", "2", "--prompt-len", "12", "--new-tokens",
                   "3", "--chunk", "4"], device="cpu")
    assert sorted(report.results) == list(range(4))
    assert all(len(r.tokens) == 3 for r in report.results.values())
