"""The port's serving path against the JAX package, on the CPU: reduced
dbrx-132b and llama4-scout-17b-a16e (the MoE families; the reduced
capacity factor 4.0 drops no token, so every lane agrees with
teacher forcing). Helpers and the shared test bodies are in
``tests/_torch_serving.py``."""
from __future__ import annotations

import pytest

from _torch_serving import *  # noqa: F401,F403
import _torch_serving as ts

FAMILY = ("dbrx-132b", "llama4-scout-17b-a16e")


@pytest.mark.parametrize("arch", FAMILY)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_chunks_and_decode_match_reference(arch, mode):
    ts.check_prefill_chunks_and_decode_match_reference(arch, mode)


@pytest.mark.parametrize("arch", FAMILY)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_greedy_equals_reference(arch, mode):
    ts.check_generate_greedy_equals_reference(arch, mode)


@pytest.mark.parametrize("arch", FAMILY)
def test_continuous_matches_generate_and_reference(arch):
    ts.check_serve_with_context_matches_generate_and_reference(arch)


@pytest.mark.parametrize("arch", FAMILY)
def test_ring_wraparound_matches_generate(arch):
    ts.check_ring_wraparound_matches_generate(arch)


@pytest.mark.parametrize("arch", FAMILY)
def test_serve_launcher_serves_moe_on_cpu(arch):
    from repro_torch.launch.serve import main
    report = main(["--arch", arch, "--smoke", "--requests", "4",
                   "--max-slots", "2", "--prompt-len", "12", "--new-tokens",
                   "3", "--chunk", "4"], device="cpu")
    assert sorted(report.results) == list(range(4))
    assert all(len(r.tokens) == 3 for r in report.results.values())
