"""The two dense configurations that ``tests/test_torch_model.py`` does
not hold, reduced qwen2-72b (q / k / v biases) and internlm2-20b, against
the JAX package on the same weights and tokens: logits, loss, gradients
and the flat layout (that file's test bodies; a file of its own so that
``--dist loadfile`` spreads the load)."""
from __future__ import annotations

import pytest

import test_torch_model as tm
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)

DENSE = ("qwen2-72b", "internlm2-20b")


@pytest.mark.parametrize("arch", DENSE)
def test_logits_and_loss_match_reference(arch):
    tm.test_logits_and_loss_match_reference(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_gradient_matches_reference(arch):
    tm.test_loss_gradient_matches_reference(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_flat_layout_matches_reference(arch):
    tm.test_flat_layout_matches_reference(arch)
