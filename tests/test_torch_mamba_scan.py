"""The port's Mamba2 SSD pieces against the JAX package on the same numpy
inputs, on the CPU: the plain version of the ``ssd_chunks`` kernel, the
model-layout entry point with a ragged last chunk, the full scan with and
without a carried-in state, ``mamba_forward`` (prefill, a chunk with
state, a decode step), the route of the chunked branch and the wrapper's
input checks. The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py`` (phase 7); here a torch emulation of its
error-compensated TF32 (3xTF32) arithmetic is held against the reference's
oracle, beside a single TF32 pass that misses the bar, and its launch
geometry is checked at the model's shapes."""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.kernels.mamba_scan import chunk_ref as jchunk_ref
from repro.kernels.mamba_scan import ssd_chunks as jssd_chunks
from repro.kernels.mamba_scan import ssd_chunks_ref as jssd_chunks_ref
from repro.kernels.mamba_scan import ssd_scan as jssd_scan
from repro.models import ssm as jssm
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import (
    LAUNCHES, chunk_ref, ops, ssd_chunks, ssd_chunks_seq, ssd_scan,
)
from repro_torch.models import ssm
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)


# the wrapper's module (the package exports its function of the same name)
ssd_mod = importlib.import_module(
    "repro_torch.kernels.mamba_scan.mamba_scan")

TOL = 1e-4
# tests/test_kernels.py::SSD_CASES: (B, H, nc, L, P, N)
SSD_CASES = [
    (1, 2, 2, 32, 16, 8),
    (2, 4, 3, 64, 32, 16),
    (1, 1, 4, 128, 64, 64),
]


def _chunked_inputs(B, H, nc, L, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, nc, L, P)).astype(np.float32)
    B_ = rng.normal(size=(B, nc, L, N)).astype(np.float32)
    C_ = rng.normal(size=(B, nc, L, N)).astype(np.float32)
    a_log = -np.log1p(np.exp(rng.normal(size=(B, H, nc, L)))).astype(
        np.float32)
    return x, B_, C_, a_log


def _seq_inputs(Bt, S, H, P, N, seed, decay=1.0):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(Bt, S, H, P)).astype(np.float32)
    B_ = rng.normal(size=(Bt, S, N)).astype(np.float32)
    C_ = rng.normal(size=(Bt, S, N)).astype(np.float32)
    a_log = (-decay * np.log1p(np.exp(rng.normal(size=(Bt, S, H))))).astype(
        np.float32)
    return xh, B_, C_, a_log


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_plain_matches_reference_kernel_and_oracle(case):
    arrays = _chunked_inputs(*case, seed=sum(case))
    LAUNCHES["ssd_chunks"] = 0
    y, st = ssd_chunks(*_t(*arrays))
    assert LAUNCHES["ssd_chunks"] == 0         # CPU tensors: plain version
    assert y.shape == arrays[0].shape and y.dtype == torch.float32
    assert st.shape == case[:3] + (case[4], case[5])
    jy, jst = jssd_chunks(*(jnp.asarray(a) for a in arrays), interpret=True)
    ry, rst = jssd_chunks_ref(*(jnp.asarray(a) for a in arrays))
    for want_y, want_st in ((jy, jst), (ry, rst)):
        _close(y, want_y)
        _close(st, want_st)


def test_chunk_ref_matches_reference():
    x, B_, C_, a_log = _chunked_inputs(1, 1, 1, 48, 8, 4, seed=9)
    y, st = chunk_ref(*_t(x[0, 0, 0], B_[0, 0], C_[0, 0], a_log[0, 0, 0]))
    jy, jst = jchunk_ref(jnp.asarray(x[0, 0, 0]), jnp.asarray(B_[0, 0]),
                         jnp.asarray(C_[0, 0]), jnp.asarray(a_log[0, 0, 0]))
    _close(y, jy)
    _close(st, jst)


@pytest.mark.parametrize("t_valid", [1, 70, 95])
def test_t_valid_equals_the_reference_zero_padding(t_valid):
    """A sequence of ``t_valid`` tokens in the model's layout ends in a
    ragged chunk; the kernel reads the tokens past it (the kernel's
    ``t_valid`` is S) as zero. Held against the reference's own zero
    padding: its chunked layout with the tail of the last chunk zeroed."""
    B, H, nc, L, P, N = 2, 3, 3, 32, 16, 8
    x, B_, C_, a_log = _chunked_inputs(B, H, nc, L, P, N, seed=t_valid)
    keep = (np.arange(nc * L) < t_valid).reshape(nc, L)
    padded = (x * keep[..., None], B_ * keep[..., None],
              C_ * keep[..., None], a_log * keep)
    want_y, want_st = jssd_chunks_ref(*(jnp.asarray(a) for a in padded))
    n_c = -(-t_valid // L)
    want_y = np.asarray(want_y)[:, :, :n_c].transpose(0, 2, 3, 1, 4).reshape(
        B, n_c * L, H, P)[:, :t_valid]
    # the same tokens in the model's layout, cut at t_valid
    xh = x.transpose(0, 2, 3, 1, 4).reshape(B, nc * L, H, P)[:, :t_valid]
    seq = (B_.reshape(B, nc * L, N)[:, :t_valid],
           C_.reshape(B, nc * L, N)[:, :t_valid])
    a = a_log.transpose(0, 2, 3, 1).reshape(B, nc * L, H)[:, :t_valid]
    y, st = ssd_chunks_seq(*_t(np.ascontiguousarray(xh), *seq,
                               np.ascontiguousarray(a)), L)
    assert y.shape == (B, t_valid, H, P) and st.shape == (B, n_c, H, P, N)
    _close(y, want_y)
    _close(st, np.asarray(want_st)[:, :, :n_c].transpose(0, 2, 1, 3, 4))


@pytest.mark.parametrize("S", [96, 83, 5])
def test_seq_layout_matches_chunked_layout(S):
    """``ssd_chunks_seq`` on the model layout (ragged S, strided column
    slices for B_ and C_) equals ``ssd_chunks`` on the padded chunked
    view."""
    Bt, H, P, N, L = 2, 3, 16, 8, 32
    xh, B_, C_, a_log = _seq_inputs(Bt, S, H, P, N, seed=S)
    conv = torch.from_numpy(np.concatenate([B_, C_], axis=-1))
    y, st = ssd_chunks_seq(torch.from_numpy(xh), conv[..., :N], conv[..., N:],
                           torch.from_numpy(a_log), L)
    nc = -(-S // L)
    pad = nc * L - S

    def chunked(a):
        a = np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
        return a.reshape((Bt, nc, L) + a.shape[2:])
    want_y, want_st = jssd_chunks_ref(
        jnp.asarray(chunked(xh).transpose(0, 3, 1, 2, 4)),
        jnp.asarray(chunked(B_)), jnp.asarray(chunked(C_)),
        jnp.asarray(chunked(a_log).transpose(0, 3, 1, 2)))
    want_y = np.asarray(want_y).transpose(0, 2, 3, 1, 4).reshape(
        Bt, nc * L, H, P)[:, :S]
    assert y.shape == (Bt, S, H, P) and st.shape == (Bt, nc, H, P, N)
    _close(y, want_y)
    _close(st, np.asarray(want_st).transpose(0, 2, 1, 3, 4))


@pytest.mark.parametrize("S", [96, 83])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_reference_ssd_chunked(S, with_h0):
    Bt, H, P, N, L = 2, 3, 16, 8, 32
    xh, B_, C_, a_log = _seq_inputs(Bt, S, H, P, N, seed=S + with_h0)
    h0 = (np.random.default_rng(1).normal(size=(Bt, H, P, N)).astype(
        np.float32) if with_h0 else None)
    want_y, want_h = jssm._ssd_chunked(
        *(jnp.asarray(a) for a in (xh, B_, C_, a_log)), L,
        h0=None if h0 is None else jnp.asarray(h0))
    y, h = ssd_scan(*_t(xh, B_, C_, a_log), L,
                    h0=None if h0 is None else torch.from_numpy(h0))
    _close(y, want_y)
    _close(h, want_h)
    # the port's plain route agrees with the reference too
    py, ph = ssm._ssd_chunked(*_t(xh, B_, C_, a_log), L,
                              h0=None if h0 is None else torch.from_numpy(h0))
    _close(py, want_y)
    _close(ph, want_h)


def test_ssd_scan_matches_reference_ops_ssd_scan():
    """Against the reference's kernel-backed ``ssd_scan`` (its chunked
    layout, interpret mode), at a strong decay."""
    Bt, S, H, P, N, L = 2, 128, 2, 16, 8, 32
    xh, B_, C_, a_log = _seq_inputs(Bt, S, H, P, N, seed=11, decay=6.0)
    nc = S // L
    want_y, want_h = jssd_scan(
        jnp.asarray(xh.reshape(Bt, nc, L, H, P).transpose(0, 3, 1, 2, 4)),
        jnp.asarray(B_.reshape(Bt, nc, L, N)),
        jnp.asarray(C_.reshape(Bt, nc, L, N)),
        jnp.asarray(a_log.reshape(Bt, nc, L, H).transpose(0, 3, 1, 2)))
    y, h = ssd_scan(*_t(xh, B_, C_, a_log), L)
    _close(y, np.asarray(want_y).transpose(0, 2, 3, 1, 4).reshape(
        Bt, S, H, P))
    _close(h, want_h)


# ---------------------------------------------------------------------------
# the kernel's arithmetic: 3xTF32 on the tensor cores, emulated
# ---------------------------------------------------------------------------

def _tf32(v):
    """``cvt.rna.tf32.f32``: round to nearest, ties away from zero, the 13
    low mantissa bits cleared (adding half of the dropped range to the
    magnitude's bits carries into the kept ones)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _mm(a, b, passes):
    """a @ b as the kernel's mma.sync takes it: TF32 operands, fp32 sums;
    3 passes are hi.hi + hi.lo + lo.hi, 1 pass hi.hi alone."""
    ah, al = _split(a)
    bh, bl = _split(b)
    out = ah @ bh
    return al @ bh + ah @ bl + out if passes == 3 else out


def _emulate(x, B_, C_, a_log, passes):
    """``ssd_chunks`` as the kernel computes it: G = C B^T on the tensor
    cores, S = G o exp(la_t - la_s) (zero where s > t) formed in fp32 and
    split, y = S x and state = x^T (B o rem) on the tensor cores."""
    L = x.shape[3]
    la = torch.cumsum(a_log, dim=-1)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    seg = la[..., :, None] - la[..., None, :]
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                        0.0)
    G = _mm(C_, B_.transpose(-1, -2), passes)          # (B, nc, t, s)
    y = _mm(G[:, None] * decay, x, passes)
    rem = torch.exp(la[..., -1:] - la)
    st = _mm(x.transpose(-1, -2), B_[:, None] * rem[..., None], passes)
    return y, st


def _scale_err(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


# the SSD_CASES, then zamba2-7b's chunk (L = 128, P = N = 64) over heads
# whose decay spans its A = 1..8 (la falls to about -700 over a chunk)
EMU_CASES = SSD_CASES + ["serving decay"]


def _emu_inputs(case):
    if case != "serving decay":
        return _chunked_inputs(*case, seed=sum(case))
    x, B_, C_, a_log = _chunked_inputs(1, 8, 2, 128, 64, 64, seed=7)
    span = np.linspace(1.0, 8.0, 8, dtype=np.float32)[None, :, None, None]
    return x, B_, C_, a_log * span


def _emu_errs(case, passes):
    arrays = _emu_inputs(case)
    y, st = _emulate(*_t(*arrays), passes)
    ry, rst = jssd_chunks_ref(*(jnp.asarray(a) for a in arrays))
    return _scale_err(y, ry), _scale_err(st, rst)


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_3xtf32_emulation_matches_oracle(case):
    """The kernel's split arithmetic holds the reference's oracle to TOL
    of each output's scale (chip_smoke.py's bar for the kernel)."""
    err_y, err_st = _emu_errs(case, passes=3)
    print(f"3xTF32 {case}: y {err_y:.3e}, states {err_st:.3e}")
    assert err_y <= TOL and err_st <= TOL, (err_y, err_st)


@pytest.mark.parametrize("case", EMU_CASES, ids=str)
def test_single_tf32_pass_misses_the_bar(case):
    """Why the kernel splits: one TF32 pass (hi.hi alone) on the same
    inputs lands above TOL on every case (the errors print with ``-s``;
    PERF.md records them)."""
    err_y, err_st = _emu_errs(case, passes=1)
    print(f"one TF32 pass {case}: y {err_y:.3e}, states {err_st:.3e}")
    assert max(err_y, err_st) > TOL, (err_y, err_st)
    assert max(err_y, err_st) < 1e-2, (err_y, err_st)


# (Bt, S, H, L, P, N): zamba2-7b's 4 x 8160 prefill, a 512-token chunk of
# its chunked prefill, the serving launcher's 64-token chunk, and the
# SSD_CASES (S = nc L)
GEOMETRY_SHAPES = {
    "serving": (4, 8160, 112, 128, 64, 64),
    "chunk512": (1, 512, 112, 128, 64, 64),
    "launcher64": (1, 64, 112, 128, 64, 64),
    **{str(c): (c[0], c[2] * c[3], c[1], c[3], c[4], c[5])
       for c in SSD_CASES},
}


@pytest.mark.parametrize("name", list(GEOMETRY_SHAPES))
def test_geometry_fills_the_card(name):
    Bt, S, H, L, P, N = GEOMETRY_SHAPES[name]
    geo = ssd_mod.geometry(Bt, S, H, L, P, N)
    nc = -(-S // L)
    assert 1 <= geo.heads_per_block <= ssd_mod.MAX_HEADS
    assert geo.groups == -(-H // geo.heads_per_block)
    assert geo.grid == (nc, geo.groups, Bt)
    assert geo.blocks == nc * geo.groups * Bt
    # the grid fills the card's SMs wherever there are that many
    # (chunk, head) pairs
    assert geo.blocks >= min(ssd_mod.NUM_SMS, Bt * nc * H)
    assert geo.threads == 256
    assert geo.smem_bytes <= ssd_mod.SMEM_MAX
    assert geo.c_args() == (geo.heads_per_block, 256, geo.smem_bytes)
    want = {"serving": (28, 1024), "chunk512": (2, 224),
            "launcher64": (1, 112)}
    if name in want:
        assert (geo.heads_per_block, geo.blocks) == want[name]


def test_geometry_shared_bytes_match_the_kernel_layout():
    """The kernel's ``Layout`` at L = 128, P = N = 64, 16 heads: x^T of two
    heads split into hi and lo 4 x 32 KiB, G's 136 causal 8 x 8 blocks, B,
    la and rem (rows of 17 heads: an odd count)."""
    assert ssd_mod.smem_bytes(128, 64, 64, 16) == 4 * (
        4 * 128 * 64 + 136 * 64 + 128 * 64 + 2 * 128 * 17) == 216_064
    # C (rows to 16) outgrows x^T at P = 16, N = 64
    assert ssd_mod.smem_bytes(40, 16, 64, 1) == 4 * (
        4 * 48 * 64 + 15 * 64 + 40 * 64 + 2 * 40)
    assert ssd_mod.geometry(4, 8160, 112, 128).smem_bytes == 4 * (
        4 * 128 * 64 + 136 * 64 + 128 * 64 + 2 * 128 * 29)
    assert ssd_mod.smem_bytes(128, 64, 64, ssd_mod.MAX_HEADS) <= (
        ssd_mod.SMEM_MAX)
    with pytest.raises(ValueError, match="no geometry"):
        ssd_mod.geometry(0, 64, 112, 128)


# ---------------------------------------------------------------------------
# mamba_forward
# ---------------------------------------------------------------------------

def _mamba_setup(seed=0):
    jcfg = jreduced(jget_arch("zamba2-7b"))
    cfg = reduced(get_arch("zamba2-7b"))
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # a non-zero conv bias and norms, so every parameter matters
    rng = np.random.default_rng(seed)
    jp = dict(jp, conv_b=jnp.asarray(rng.normal(size=jp["conv_b"].shape),
                                     jnp.float32) * 0.1,
              norm=jnp.asarray(rng.normal(size=jp["norm"].shape),
                               jnp.float32) * 0.1,
              dt_bias=jnp.asarray(rng.normal(size=jp["dt_bias"].shape),
                                  jnp.float32) * 0.5)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def test_mamba_forward_prefill_chunk_and_decode_match_reference():
    jcfg, cfg, jp, p = _mamba_setup()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 77, cfg.d_model)).astype(np.float32)
    first, second, step = x[:, :45], x[:, 45:76], x[:, 76:]

    # prefill from scratch (no state)
    jout, jst = jssm.mamba_forward(jp, jnp.asarray(first), jcfg)
    with torch.no_grad():
        out, st = ssm.mamba_forward(p, torch.from_numpy(first), cfg)
    _close(out, jout)
    _close(st["ssm"], jst["ssm"])
    _close(st["conv"], jst["conv"])

    # a chunk with the carried state, then a decode step: in place
    state = ssm.init_mamba_state(cfg, 2, torch.float32, device="cpu")
    state["ssm"].copy_(st["ssm"])
    state["conv"].copy_(st["conv"])
    for part in (second, step):
        jout, jst = jssm.mamba_forward(jp, jnp.asarray(part), jcfg, jst)
        with torch.no_grad():
            out, new = ssm.mamba_forward(p, torch.from_numpy(part), cfg,
                                         state)
        assert new is state
        _close(out, jout)
        _close(state["ssm"], jst["ssm"])
        _close(state["conv"], jst["conv"])

    # the whole sequence at once equals the streamed one
    jall, _ = jssm.mamba_forward(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        whole, _ = ssm.mamba_forward(p, torch.from_numpy(x), cfg)
    _close(whole[:, -1], jall[:, -1])
    _close(whole[:, -1], out[:, 0])


def test_mamba_init_state_matches_reference():
    jcfg, cfg, _, _ = _mamba_setup()
    jst = jssm.init_mamba_state(jcfg, 3, jnp.float32)
    st = ssm.init_mamba_state(cfg, 3, torch.float32, device="cpu")
    for name in ("ssm", "conv"):
        assert tuple(st[name].shape) == jst[name].shape
        assert not bool(st[name].any())
    jparams = jssm.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = ssm.init_mamba(None, cfg, torch.float32, device="meta")
    assert sorted(params) == sorted(jparams)
    for name, leaf in params.items():
        assert tuple(leaf.shape) == jparams[name].shape, name
    for name in ("A_log", "D", "dt_bias"):
        assert params[name].dtype == torch.float32
    _close(ssm.init_mamba(torch.Generator().manual_seed(0), cfg,
                          torch.float32, device="cpu")["A_log"],
           jparams["A_log"])


def test_chunked_branch_routes_by_gradient(monkeypatch):
    """With no gradient recorded the chunked branch goes through
    ``ops.ssd_scan`` (the kernel on a card), with one recorded through the
    plain ``_ssd_chunked``; a decode step takes neither."""
    _, cfg, _, p = _mamba_setup()
    calls = []
    real_scan, real_plain = ops.ssd_scan, ssm._ssd_chunked

    def spy(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(ops, "ssd_scan", spy("kernel", real_scan))
    monkeypatch.setattr(ssm, "_ssd_chunked", spy("plain", real_plain))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 40, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want, st = ssm.mamba_forward(p, x, cfg)
    assert calls == ["kernel"]
    grad_p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    got, _ = ssm.mamba_forward(grad_p, x, cfg)
    assert calls == ["kernel", "plain"]
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0,
                               atol=TOL)
    got.sum().backward()
    assert all(v.grad is not None for v in grad_p.values())
    with torch.no_grad():
        ssm.mamba_forward(p, x[:, :1], cfg, st)
    assert calls == ["kernel", "plain"]


def _z(d, *shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=d)


@pytest.mark.parametrize("make, err, match", [
    (lambda d: (_z(d, 1, 2, 2, 32, 16), _z(d, 1, 2, 32, 8),
                _z(d, 1, 2, 32, 8), _z(d, 1, 2, 2)), ValueError, "4-D"),
    (lambda d: (_z(d, 1, 2, 2, 32, 16), _z(d, 1, 2, 32, 8),
                _z(d, 1, 2, 32, 8, dtype=torch.bfloat16),
                _z(d, 1, 2, 2, 32)), TypeError, "float32"),
    (lambda d: (_z(d, 1, 2, 2, 32, 16), _z(d, 1, 2, 32, 8),
                _z(d, 1, 2, 32, 4), _z(d, 1, 2, 2, 32)), ValueError,
     "do not agree"),
    (lambda d: (_z(d, 1, 2, 2, 256, 16), _z(d, 1, 2, 256, 8),
                _z(d, 1, 2, 256, 8), _z(d, 1, 2, 2, 256)), ValueError,
     "L <= 128"),
    (lambda d: (_z(d, 1, 2, 2, 32, 128), _z(d, 1, 2, 32, 8),
                _z(d, 1, 2, 32, 8), _z(d, 1, 2, 2, 32)), ValueError,
     "P <= 64"),
    (lambda d: (_z(d, 1, 2, 2, 32, 32)[..., ::2], _z(d, 1, 2, 32, 8),
                _z(d, 1, 2, 32, 8), _z(d, 1, 2, 2, 32)), ValueError,
     "contiguous"),
    (lambda d: (_z(d, 1, 2, 2, 36, 16), _z(d, 1, 2, 36, 8),
                _z(d, 1, 2, 36, 8), _z(d, 1, 2, 2, 36)), ValueError,
     "multiples of 8"),
    (lambda d: (_z(d, 1, 2, 2, 32, 16), _z(d, 1, 2, 32, 6),
                _z(d, 1, 2, 32, 6), _z(d, 1, 2, 2, 32)), ValueError,
     "N <= 64 in multiples of 8"),
    # the tensor-core tiles: P in m16 tiles, N in n8 tiles
    (lambda d: (_z(d, 1, 2, 2, 32, 8), _z(d, 1, 2, 32, 8),
                _z(d, 1, 2, 32, 8), _z(d, 1, 2, 2, 32)), ValueError,
     "P <= 64 in multiples of 16"),
    (lambda d: (_z(d, 1, 2, 2, 32, 16), _z(d, 1, 2, 32, 12),
                _z(d, 1, 2, 32, 12), _z(d, 1, 2, 2, 32)), ValueError,
     "N <= 64 in multiples of 8"),
    # the kernel reads x and C_ in pairs of floats
    (lambda d: (_z(d, 1, 2, 2, 32, 17)[..., :16], _z(d, 1, 2, 32, 8),
                _z(d, 1, 2, 32, 8), _z(d, 1, 2, 2, 32)), ValueError,
     "even strides"),
    (lambda d: (_z(d, 1, 2, 2, 32, 16), _z(d, 1, 2, 32, 8),
                _z(d, 1, 2, 32, 9)[..., 1:], _z(d, 1, 2, 2, 32)), ValueError,
     "8-byte boundary"),
], ids=["rank", "dtype", "shapes", "chunk", "head-dim", "strided",
        "ragged-chunk", "ragged-state", "head-dim-m16", "state-n8",
        "x-pairs", "c-pairs"])
def test_guards_raise_before_dispatch_and_build(monkeypatch, make, err,
                                                match):
    """Bad inputs raise on either device (meta stands in for a card)
    before any dispatch, launch or kernel build."""
    def no_build():
        raise AssertionError("build() reached")
    monkeypatch.setattr(ssd_mod, "build", no_build)
    LAUNCHES["ssd_chunks"] = 0
    for device in ("cpu", "meta"):
        with pytest.raises(err, match=match):
            ssd_chunks(*make(device))
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_chunks(_z("meta", 1, 2, 2, 32, 16), _z("meta", 1, 2, 32, 8),
                   _z("meta", 1, 2, 32, 8), _z("meta", 1, 2, 2, 32))
    with pytest.raises(ValueError, match="do not agree"):
        ssd_chunks_seq(_z("cpu", 1, 40, 2, 16), _z("cpu", 1, 40, 8),
                       _z("cpu", 1, 40, 8), _z("cpu", 1, 41, 2), 32)
    assert LAUNCHES["ssd_chunks"] == 0
    assert "mamba_scan" not in _build._libs


def test_reference_ssm_docstring_names_a_missing_oracle():
    """A fault of the reference (ROADMAP.md Queue 3): ``repro/models/
    ssm.py``'s docstring says the Pallas kernel "is validated against
    ``_ssd_reference`` here", but the module has no such function; the
    kernel is validated against ``_ssd_chunked`` and
    ``kernels/mamba_scan/ref.py``. The port's tests hold it against both."""
    assert "_ssd_reference" in jssm.__doc__
    assert not hasattr(jssm, "_ssd_reference")
    assert callable(jssm._ssd_chunked)
