"""The port's serving path against the JAX package, on the CPU: reduced
xlstm-350m at 8 layers (the family's slowest cases, in a file of their own).
Helpers and the shared test bodies are in ``tests/_torch_serving.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_serving import *  # noqa: F401,F403
import _torch_serving as ts

FAMILY = ('xlstm-350m@8',)


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
