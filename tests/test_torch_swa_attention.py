"""The port's sliding-window attention (plain version, model-layout ops and
the wrapper's guards) against the JAX package on the same numpy inputs, on
the CPU. The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py`` (phase 5)."""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention import swa_attention as jswa_attention
from repro.kernels.swa_attention import swa_attention_ref as jswa_ref
from repro.models.attention import attend as jattend
from repro_torch.kernels import _build
from repro_torch.kernels.swa_attention import (
    LAUNCHES, attention, swa_attention, swa_attention_plain,
)
from repro_torch.models import attention as attn

# the wrapper's module (the package exports its function of the same name)
swa_mod = importlib.import_module(
    "repro_torch.kernels.swa_attention.swa_attention")

# tests/test_kernels.py::ATTN_CASES: (B, H, Hkv, Sq, Skv, hd, window, cap)
ATTN_CASES = [
    (1, 4, 4, 128, 128, 64, 0, 0.0),
    (2, 4, 2, 256, 256, 64, 0, 0.0),          # GQA
    (1, 8, 4, 384, 384, 128, 128, 0.0),       # window
    (1, 2, 1, 512, 512, 64, 0, 50.0),         # softcap
    (2, 4, 4, 200, 200, 64, 96, 30.0),        # ragged + window + cap
    (1, 4, 2, 128, 1024, 64, 256, 0.0),       # long kv, banded
]
# ragged kv lengths whose padded keys causality does not mask
RAGGED_CASES = [
    # (B, H, Hkv, Sq, Skv, hd, window, cap, causal)
    (1, 2, 1, 128, 200, 64, 0, 0.0, False),
    (1, 2, 1, 300, 200, 64, 0, 0.0, True),
]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, H, Hkv, Sq, Skv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, hd)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, hd)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, hd)).astype(np.float32))


def _both(arrays, dtype):
    """The same values in both frameworks (bf16: rounded once, in jax)."""
    _, jdt, tdt, _ = DTYPES[dtype]
    j = [jnp.asarray(a, jdt) for a in arrays]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
         for a in j]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_oracle(case, dtype):
    B, H, Hkv, Sq, Skv, hd, window, cap = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, H, Hkv, Sq, Skv, hd, 0), dtype)
    want = jswa_ref(jq, jk, jv, window=window, cap=cap)
    LAUNCHES["swa_attention"] = 0
    got = swa_attention(q, k, v, window=window, cap=cap)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert LAUNCHES["swa_attention"] == 0      # CPU tensors: plain version
    _close(got, want, DTYPES[dtype][3])


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_kernel(case, dtype):
    """Against the Pallas kernel in interpret mode (all six cases are
    causal with Sq == Skv, where its padding is masked)."""
    B, H, Hkv, Sq, Skv, hd, window, cap = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, H, Hkv, Sq, Skv, hd, 1), dtype)
    want = jswa_attention(jq, jk, jv, window=window, cap=cap, bq=128, bk=128,
                          interpret=True)
    got = swa_attention_plain(q, k, v, window=window, cap=cap)
    _close(got, want, DTYPES[dtype][3])


@pytest.mark.parametrize("case", RAGGED_CASES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_kv_matches_reference_oracle(case, dtype):
    """Keys past Skv never enter the softmax. Held against the oracle only:
    the Pallas kernel pads k / v with zeros and does not mask the padded
    keys here (ROADMAP.md Queue 3, the swa_attention padded-key entry)."""
    B, H, Hkv, Sq, Skv, hd, window, cap, causal = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, H, Hkv, Sq, Skv, hd, 2), dtype)
    want = jswa_ref(jq, jk, jv, causal=causal, window=window, cap=cap)
    got = swa_attention(q, k, v, causal=causal, window=window, cap=cap)
    _close(got, want, DTYPES[dtype][3])


@pytest.mark.parametrize("Sq, Skv, causal, faulty", [
    (128, 200, False, True), (300, 200, True, True),
    (200, 200, True, False)])
def test_reference_kernel_counts_padded_keys(Sq, Skv, causal, faulty):
    """Why the ragged cases are held against the oracle: the Pallas kernel
    pads k / v with zeros to a multiple of bk and never masks kpos >= Skv,
    so where causality does not mask the padded keys each one enters the
    softmax (ROADMAP.md Queue 3). With Sq == Skv and causal it agrees."""
    q, k, v = (jnp.asarray(a) for a in _inputs(1, 2, 1, Sq, Skv, 64, 2))
    err = float(jnp.max(jnp.abs(
        jswa_attention(q, k, v, causal=causal, bq=128, bk=128,
                       interpret=True)
        - jswa_ref(q, k, v, causal=causal))))
    assert (err > 1e-2) if faulty else (err < 1e-5), err


def test_ops_attention_matches_model_attend():
    """The model-layout wrapper against the reference model's chunked
    online-softmax attention (test_swa_attention_matches_model_attend's
    setup)."""
    B, S, H, Hkv, hd, W = 2, 256, 4, 2, 64, 64
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    pos = jnp.arange(S)
    want = jattend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=pos,
                   kv_pos=pos, causal=True, window=W)
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=True, window=W)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # and the port's own attend, with a softcap
    tp = torch.arange(S, dtype=torch.int32)
    mine = attn.attend(*(torch.from_numpy(a) for a in (q, k, v)), q_pos=tp,
                       kv_pos=tp, window=W, cap=50.0)
    np.testing.assert_allclose(
        attention(*(torch.from_numpy(a) for a in (q, k, v)), window=W,
                  cap=50.0).numpy(), mine.numpy(), rtol=2e-5, atol=2e-5)


def _z(d, *shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=d)


@pytest.mark.parametrize("make, err, match", [
    (lambda d: (_z(d, 1, 2, 8, 96), _z(d, 1, 1, 8, 96), _z(d, 1, 1, 8, 96)),
     ValueError, "head_dim"),
    (lambda d: (_z(d, 1, 2, 8, 64), _z(d, 1, 1, 8, 64, dtype=torch.bfloat16),
                _z(d, 1, 1, 8, 64)), TypeError, "mixed dtypes"),
    (lambda d: (_z(d, 1, 3, 8, 64), _z(d, 1, 2, 8, 64), _z(d, 1, 2, 8, 64)),
     ValueError, "heads"),
    (lambda d: (_z(d, 1, 2, 8, 64, dtype=torch.float64),) * 3,
     TypeError, "float32 and"),
    (lambda d: (_z(d, 1, 2, 8, 128)[..., ::2], _z(d, 1, 1, 8, 64),
                _z(d, 1, 1, 8, 64)), ValueError, "contiguous"),
], ids=["hd", "mixed-dtypes", "heads", "float64", "strided"])
def test_guards_raise_before_dispatch_and_build(monkeypatch, make, err,
                                                match):
    """Bad inputs raise on either device (meta stands in for a card)
    before any dispatch, launch or kernel build."""
    def no_build():
        raise AssertionError("build() reached")
    monkeypatch.setattr(swa_mod, "build", no_build)
    LAUNCHES["swa_attention"] = 0
    for device in ("cpu", "meta"):
        with pytest.raises(err, match=match):
            swa_attention(*make(device))
    with pytest.raises(ValueError, match="unsupported device"):
        swa_attention(*(_z("meta", 1, 2, 8, 64),) * 3)
    assert LAUNCHES["swa_attention"] == 0
    assert "swa_attention" not in _build._libs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_head_dim_112_passes_the_checks_and_matches_reference(dtype):
    """zamba2-7b's shared attention (head_dim 112, 32 heads over 32 kv
    heads): the wrapper takes it (a meta tensor gets past every check to
    the device test, before any build), and on the CPU it equals the
    reference's oracle."""
    B, H, Hkv, Sq, Skv, hd = 1, 4, 4, 160, 160, 112
    assert 112 in swa_mod.HEAD_DIMS
    LAUNCHES["swa_attention"] = 0
    with pytest.raises(ValueError, match="unsupported device"):
        swa_attention(*(_z("meta", B, H, Sq, hd),) * 3)
    assert "swa_attention" not in _build._libs
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, H, Hkv, Sq, Skv, hd, 4), dtype)
    want = jswa_ref(jq, jk, jv)
    got = swa_attention(q, k, v)
    assert LAUNCHES["swa_attention"] == 0
    _close(got, want, DTYPES[dtype][3])
