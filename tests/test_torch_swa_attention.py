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


# --- the bf16 tensor-core route's numerics ---------------------------------

LOG2E = 1.4426950408889634
# (B, H, Hkv, Sq, Skv, hd, window, cap): gemma2-2b's head_dim with GQA 2, a
# window and its softcap on a ragged length; zamba2-7b's head_dim at cap 0
ROUTE_CASES = [
    (2, 8, 4, 333, 333, 256, 96, 50.0),
    (1, 4, 4, 200, 200, 112, 0, 0.0),
] + ATTN_CASES


def _emulate_wgmma_route(q, k, v, *, window, cap, bk=64):
    """A plain emulation of the bf16 kernel's rounding choices: bf16 q, k,
    v; fp32 products; the scale applied to the fp32 score; the softcap in
    its exp form, cap (1 - 2 / (1 + 2^(2 log2e x / cap))); the online
    softmax in the log2 domain over kv tiles of ``bk`` keys, a row's max
    moved only when a tile passes it by more than 8 (P below 2^8), P
    rounded to bf16 before P V and the sum l taken over fp32 P; causal."""
    B, H, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.to(torch.bfloat16).float()
    kf = k.to(torch.bfloat16).float().repeat_interleave(H // Hkv, dim=1)
    vf = v.to(torch.bfloat16).float().repeat_interleave(H // Hkv, dim=1)
    qpos = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Skv, bk):
        kpos = torch.arange(k0, min(k0 + bk, Skv))[None, :]
        x = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2) * hd ** -0.5
        if cap:
            t = cap * LOG2E - 2 * cap * LOG2E / (
                1 + torch.exp2(x * (2 * LOG2E / cap)))
        else:
            t = x * LOG2E
        ok = kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        t = t.masked_fill(~ok, float("-inf"))
        t_max = t.amax(dim=-1, keepdim=True)
        m_new = torch.where(t_max > m + 8, t_max, m)
        p = torch.exp2(t - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :,
                                                             k0:k0 + bk]
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("case", ROUTE_CASES, ids=str)
def test_wgmma_route_numerics_within_half_the_bf16_tolerance(case):
    """The bf16 kernel's rounding choices against the JAX oracle: the
    emulation's error stays within half the bf16 tolerance (2e-2 of the
    output's scale), so the kernel keeps the other half for its order of
    summation. The kernel itself meets the whole tolerance on the card
    (``chip_smoke.py`` phase 5)."""
    B, H, Hkv, Sq, Skv, hd, window, cap = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, H, Hkv, Sq, Skv, hd, 5),
                                    "bfloat16")
    want = np.asarray(jswa_ref(jq, jk, jv, window=window, cap=cap),
                      np.float32)
    got = _emulate_wgmma_route(q, k, v, window=window, cap=cap)
    err = float(np.abs(got.float().numpy() - want).max())
    scale = float(np.abs(want).max())
    assert err <= 0.5 * DTYPES["bfloat16"][3] * scale, (err, scale)


def _bf16_meta(shape, offset=0):
    """A bf16 meta tensor of ``shape`` that starts ``offset`` elements into
    its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16,
                       device="meta")[offset:].view(shape)


@pytest.mark.parametrize("make, match", [
    (lambda: (_bf16_meta((1, 2, 8, 64), offset=4),) * 3, "aligned"),
    (lambda: (torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16,
                          device="meta")[..., :64],) * 3, "multiple of 8"),
    (lambda: (_bf16_meta((1, 2, 8, 64)),
              torch.zeros(1, 1, 8, 70, dtype=torch.bfloat16,
                          device="meta")[..., 3:67],
              _bf16_meta((1, 1, 8, 64))), "aligned"),
], ids=["base", "stride", "k-base"])
def test_tma_guards_raise_before_build(monkeypatch, make, match):
    """A bf16 input off the CPU that TMA cannot describe (a base not 16-byte
    aligned, a stride not a multiple of 8 elements) raises before any
    build or launch: it never goes quietly to the fp32 kernel or the plain
    version. On the CPU the plain version takes the same layouts."""
    def no_build():
        raise AssertionError("build() reached")
    monkeypatch.setattr(swa_mod, "build", no_build)
    LAUNCHES["swa_attention"] = 0
    with pytest.raises(ValueError, match=match):
        swa_attention(*make())
    cpu = [torch.zeros(t.shape, dtype=torch.bfloat16) for t in make()]
    assert swa_attention(*cpu).shape == cpu[0].shape
    assert LAUNCHES["swa_attention"] == 0
    assert "swa_attention" not in _build._libs


@pytest.mark.parametrize("arch", ["gemma2-2b", "zamba2-7b"])
def test_model_views_pass_the_tma_guards(monkeypatch, arch):
    """The serving prefill's own q, k, v: ``qkv_proj`` and ``rope`` on a
    (B, S, d_model) bf16 input at the config's full width, viewed
    (B, H, S, hd) by ``ops.attention``, pass every check up to the device
    test (meta stands in for a card), with no copy made."""
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import rope
    cfg = get_arch(arch)
    B, S, d = 2, 96, cfg.d_model
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def w(n):
        return torch.zeros((d, n), dtype=torch.bfloat16, device="meta")
    p = {"wq": w(H * hd), "wk": w(Hkv * hd), "wv": w(Hkv * hd)}
    h = torch.zeros((B, S, d), dtype=torch.bfloat16, device="meta")
    q, k, v = attn.qkv_proj(p, h, H, Hkv, hd)
    pos = torch.arange(S, dtype=torch.int32, device="meta")
    q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    swa_mod._check_tma(views)
    monkeypatch.setattr(swa_mod, "build", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match="unsupported device"):
        attention(q, k, v, causal=True, window=cfg.sliding_window or 0,
                  cap=cfg.attn_logit_softcap)
    assert v.transpose(1, 2).stride() == (S * Hkv * hd, hd, Hkv * hd, 1)


# --- chip_smoke.py phase 5's own checks, on the CPU -------------------------

def _smoke():
    import chip_smoke
    return chip_smoke


def test_smoke_row_bar_catches_a_wrong_long_row():
    """Phase 5 holds each query row to 2e-2 of its own largest |output|. A
    causal row over n keys has outputs of order n^-1/2, so long rows off
    by 10% stay under 2e-2 of the whole tensor's scale (set by the first
    rows) and fail the row bar; a right answer reads 0."""
    cs = _smoke()
    tol = cs.ATTN_TOL[torch.bfloat16]
    q, k, v = (torch.from_numpy(t) for t in np.random.default_rng(0)
               .standard_normal((3, 1, 2, 2048, 64), dtype=np.float32))
    want = swa_attention_plain(q, k, v, causal=True, window=0, cap=0.0)
    got = want.clone()
    got[:, :, 1024:] *= 1.1
    tensor_rel = float((got - want).abs().max() / want.abs().max())
    assert tensor_rel <= tol
    assert cs._row_rel_err(got, want) > tol
    assert cs._row_rel_err(want, want) == 0.0


def test_smoke_sass_census_counts_wgmma(monkeypatch):
    """The SASS census names each instance, its highest register and its
    HGMMA count, from ``cuobjdump -sass``'s listing."""
    import types
    cs = _smoke()
    listing = "\n".join([
        "\t\tFunction : _Z16swa_wgmma_kernelILi112EEv14CUtensorMap_st",
        "\t/*0010*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        "\t/*0020*/  HGMMA.64x48x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;",
        "\t/*0030*/  FADD R157, R2, UR5 ;",
        "\t\tFunction : _Z10swa_kernelILi64EEvPKfS1_S1_Pf",
        "\t/*0000*/  FFMA R12, R3, R4, R12 ;",
    ])
    monkeypatch.setattr(cs.shutil, "which", lambda name: name)
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **kw:
                        types.SimpleNamespace(stdout=listing))
    assert cs._sass_census("lib.so") == {
        "swa_wgmma_kernel<112>": (157, 2), "swa_kernel<64>": (12, 0)}


def test_smoke_model_layout_passes_the_tma_guards():
    """Phase 5's second bf16 layout has the values of its input and the
    strides of the model's transposed (B, S, H, hd) view, which the TMA
    guards take."""
    cs = _smoke()
    t = torch.randn(2, 4, 96, 112).bfloat16()
    m = cs._model_layout(t)
    assert torch.equal(m, t) and m.stride() == (96 * 4 * 112, 112,
                                                4 * 112, 1)
    swa_mod._check_tma([cs._model_layout(torch.zeros(
        2, 4, 96, 112, dtype=torch.bfloat16, device="meta"))] * 3)
