"""The port's serving path against the JAX package, on the CPU: reduced
internvl2-2b (the vlm family: a stubbed patch-embedding prefix before the
tokens). Without a prefix the lanes are the dense ones; requests that
carry a prefix (``Request.prefix``) decode after it. Helpers and the
shared test bodies are in ``tests/_torch_serving.py``."""
from __future__ import annotations

import numpy as np
import pytest

from _torch_serving import *  # noqa: F401,F403
import _torch_serving as ts

ARCH = "internvl2-2b"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_chunks_and_decode_match_reference(mode):
    ts.check_prefill_chunks_and_decode_match_reference(ARCH, mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_greedy_equals_reference(mode):
    ts.check_generate_greedy_equals_reference(ARCH, mode)


def test_continuous_with_prefix_matches_generate_and_reference():
    ts.check_serve_with_context_matches_generate_and_reference(ARCH)


def test_reference_launcher_serves_vlm_without_its_prefix(capsys):
    """A fault of the reference (ROADMAP.md Queue 3): its serving launcher
    counts a vlm config's n_prefix positions in buf_len but gives neither
    its requests nor its example batch a prefix, so internvl2-2b is served
    without its image. The port's launcher mirrors it: the same buf_len
    (8 + 24 + 3 on the reduced config), requests without a prefix, slots
    starting at 0."""
    from repro.launch import serve as jserve_launcher
    from repro_torch.launch.serve import build_requests, main
    argv = ["--arch", ARCH, "--smoke", "--requests", "3", "--max-slots",
            "2", "--prompt-len", "12", "--new-tokens", "3", "--chunk", "4"]
    report = main(argv, device="cpu")
    mine = capsys.readouterr().out
    jreport = jserve_launcher.main(argv)
    theirs = capsys.readouterr().out
    for out in (mine, theirs):
        assert "buf=35 " in out, out
    assert sorted(report.results) == sorted(jreport.results) == [0, 1, 2]
    cfg = reduced(get_arch(ARCH))
    assert all(r.prefix is None and r.enc is None
               for r in build_requests(cfg, 0, [4, 8], 2))
    jreqs = jserve_launcher.build_requests(
        jreduced(jget_arch(ARCH)), jax.random.PRNGKey(0), [4, 8], 2)
    assert all(r.prefix is None and r.enc is None for r in jreqs)
