"""The port's sLSTM / mLSTM pieces against the JAX package on the same
numpy inputs, on the CPU: the plain version of the ``slstm_steps`` kernel
and ``slstm_scan`` (the wrapper's CPU route) against the reference's
plain version and its Pallas kernel in interpret mode, with fresh and
carried states and T = 1; ``slstm_forward`` on either route and
``mlstm_forward`` on both of its branches (prefill, a chunk with a
carried state, a decode step); the route of the sLSTM recurrence and the
wrapper's input checks. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py`` (phase 9)."""
from __future__ import annotations

import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.kernels.slstm_step import slstm_scan as jslstm_scan
from repro.kernels.slstm_step import slstm_steps_ref as jslstm_steps_ref
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import _build
from repro_torch.kernels.slstm_step import (
    HEAD_DIMS, LAUNCHES, ops, slstm_scan, slstm_steps, slstm_steps_ref,
)
from repro_torch.models import xlstm

# the wrapper's module (the package exports its function of the same name)
slstm_mod = importlib.import_module(
    "repro_torch.kernels.slstm_step.slstm_step")

TOL = 2e-4          # tests/test_kernels.py::test_slstm_kernel_vs_ref
ATOL = 1e-4         # the model's blocks, fp32
# tests/test_kernels.py::SLSTM_CASES: (B, T, H, P, t_blk)
SLSTM_CASES = [
    (2, 50, 2, 16, 16),
    (1, 128, 4, 32, 128),
    (2, 37, 2, 8, 64),
    (1, 16, 1, 8, 32),
]


def _inputs(B, T, H, P, seed, carried=False):
    """g_in, R and a state, as numpy. A fresh state is the model's (n at
    1e-6, m at -1e30); a carried one is what a running sequence holds."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, T, H, 4 * P)).astype(np.float32)
    R = (rng.normal(size=(H, P, 4 * P)) * P ** -0.5).astype(np.float32)
    zero = np.zeros((B, H, P), np.float32)
    if not carried:
        return g, R, (zero, zero + 1e-6, zero, zero - 1e30)
    return g, R, (rng.normal(size=zero.shape).astype(np.float32),
                  (rng.uniform(0.5, 2.0, size=zero.shape)).astype(np.float32),
                  (rng.normal(size=zero.shape) * 0.3).astype(np.float32),
                  rng.normal(size=zero.shape).astype(np.float32))


def _t(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _close_all(got, want, tol=TOL):
    (h, st), (jh, jst) = got, want
    _close(h, jh, tol)
    assert len(st) == len(jst) == 4
    for a, b in zip(st, jst):
        _close(a, b, tol)


# ---------------------------------------------------------------------------
# the kernel's plain version and the scan
# ---------------------------------------------------------------------------

CASES = [(*c, False) for c in SLSTM_CASES] + [
    (2, 40, 3, 32, 16, True),          # a carried, non-fresh state
    (3, 1, 2, 128, 128, False),        # T = 1, a decode step
    (2, 1, 2, 16, 128, True),          # T = 1 with a carried state
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_and_scan_match_reference_kernel_and_oracle(case):
    B, T, H, P, t_blk, carried = case
    g, R, st = _inputs(B, T, H, P, seed=sum(case[:5]), carried=carried)
    want_ref = jslstm_steps_ref(jnp.asarray(g), jnp.asarray(R), _j(st))
    want_kernel = jslstm_scan(jnp.asarray(g), jnp.asarray(R), _j(st),
                              t_blk=t_blk, interpret=True)
    plain = slstm_steps_ref(torch.from_numpy(g), torch.from_numpy(R),
                            _t(st))
    state = _t(st)
    LAUNCHES["slstm_steps"] = 0
    scanned = slstm_scan(torch.from_numpy(g), torch.from_numpy(R), state)
    assert LAUNCHES["slstm_steps"] == 0        # CPU tensors: plain version
    assert scanned[1] == state                  # the caller's tensors
    assert scanned[0].shape == (B, T, H, P)
    assert scanned[0].dtype == torch.float32
    for got in (plain, scanned):
        for want in (want_ref, want_kernel):
            _close_all(got, want)


def test_scan_updates_the_state_in_place_and_continues():
    """Two scans over halves of a sequence, the state carried in place,
    equal one scan over the whole (and the reference's)."""
    g, R, st = _inputs(2, 30, 2, 16, seed=3)
    state = _t(st)
    ptrs = [t.data_ptr() for t in state]
    g_t, R_t = torch.from_numpy(g), torch.from_numpy(R)
    h1, _ = slstm_scan(g_t[:, :11], R_t, state)
    h2, _ = slstm_scan(g_t[:, 11:], R_t, state)
    assert [t.data_ptr() for t in state] == ptrs
    jh, jst = jslstm_steps_ref(jnp.asarray(g), jnp.asarray(R), _j(st))
    _close_all((torch.cat([h1, h2], dim=1), state), (jh, jst))


def test_steps_without_out_state_leave_the_input_state():
    g, R, st = _inputs(1, 5, 2, 8, seed=4)
    state = _t(st)
    before = [t.clone() for t in state]
    _, final = slstm_steps(torch.from_numpy(g), torch.from_numpy(R), state)
    assert all(torch.equal(a, b) for a, b in zip(state, before))
    assert all(f is not s for f, s in zip(final, state))


# ---------------------------------------------------------------------------
# the kernel's partition of the recurrence and its launch geometry
# ---------------------------------------------------------------------------

def _emulate_partition(g, R, st, geo):
    """The recurrence in numpy fp32, split as the CUDA kernel splits it:
    per batch group of ``geo.batch_rows``, block r of the cluster owns
    state elements [r S, (r + 1) S) and R's columns q P + r S + j for the
    gates q = z, i, f, o; each column's dot product runs over its register
    rows (k < rows_reg) and then its shared rows, and is added to g_in;
    every block reads h from one buffer of a double buffer and writes its
    slice into the other."""
    B, T, H, P4 = g.shape
    P, C, S, kr = P4 // 4, geo.C, geo.S, geo.rows_reg
    c, n, h0, m = (np.array(a, np.float32) for a in st)
    out = np.zeros((B, T, H, P), np.float32)
    hf = np.zeros_like(h0)
    for b0, nb in geo.batch_rows(B):
        rows = slice(b0, b0 + nb)
        hbuf = np.zeros((2, nb, H, P), np.float32)
        hbuf[0] = h0[rows]
        for t in range(T):
            cur, nxt = hbuf[t & 1], hbuf[(t + 1) & 1]
            for r in range(C):
                own = slice(r * S, (r + 1) * S)
                cols = np.concatenate([q * P + np.arange(r * S, (r + 1) * S)
                                       for q in range(4)])
                acc = np.einsum("bhk,hkc->bhc", cur[:, :, :kr],
                                R[:, :kr][:, :, cols])
                acc = acc + np.einsum("bhk,hkc->bhc", cur[:, :, kr:],
                                      R[:, kr:][:, :, cols])
                z, i, f, o = np.split(g[rows, t][..., cols] + acc, 4, axis=-1)
                c_s, n_s, m_s = (a[rows, :, own] for a in (c, n, m))
                m_new = np.maximum(f + m_s, i)
                ie = np.exp(i - m_new)
                fe = np.exp(f + m_s - m_new)
                c[rows, :, own] = fe * c_s + ie * np.tanh(z)
                n[rows, :, own] = fe * n_s + ie
                m[rows, :, own] = m_new
                h = (np.float32(1) / (np.float32(1) + np.exp(-o))
                     * c[rows, :, own] / np.maximum(n[rows, :, own],
                                                    np.float32(1e-6)))
                nxt[:, :, own] = h
                out[rows, t, :, own] = h
        hf[rows] = hbuf[T & 1]
    return out, (c, n, hf, m)


# (B, T, H, P, C, carried): C = 1 at P = 8; C = 2 and the kernel's C = 4 at
# the reduced config's P = 128; xlstm-350m's C = 16 at P = 512
PARTITION_CASES = [
    (2, 37, 2, 8, 1, False),
    (3, 20, 2, 8, 1, True),
    (2, 9, 2, 128, 2, True),
    (5, 6, 2, 128, 4, False),          # two batch groups, the second of 1
    (1, 1, 3, 128, 4, True),           # T = 1
    (1, 3, 4, 512, 16, False),
    (1, 3, 4, 512, 16, True),
    (2, 1, 4, 512, 16, False),         # T = 1
]


@pytest.mark.parametrize("case", PARTITION_CASES, ids=str)
def test_kernel_partition_matches_reference(case):
    """Which columns of R belong to which block, the split into register
    and shared rows, the double buffer and the batch groups: the emulation
    of the kernel's partition against the reference."""
    B, T, H, P, C, carried = case
    geo = slstm_mod.geometry(P, B)
    if C != geo.C:
        geo = dataclasses.replace(geo, C=C, S=P // C)
    g, R, st = _inputs(B, T, H, P, seed=sum(case[:5]), carried=carried)
    want = jslstm_steps_ref(jnp.asarray(g), jnp.asarray(R), _j(st))
    _close_all(_emulate_partition(g, R, st, geo), want)


@pytest.mark.parametrize("B", [1, 3, 4, 8, 9])
@pytest.mark.parametrize("P", HEAD_DIMS)
def test_geometry_fits_the_card_and_covers_every_row(P, B):
    geo = slstm_mod.geometry(P, B)
    assert (geo.P, geo.G, geo.S) == (P, 4, P // geo.C)
    assert geo.smem_bytes <= slstm_mod.SMEM_MAX == 232_448
    assert 1 <= geo.C <= 16 and P % geo.C == 0
    assert geo.rows_reg + geo.rows_smem == P
    # rows go in fours (16-byte loads), and a thread's register rows fit
    # beside its other registers
    assert geo.rows_reg % 4 == 0 and geo.rows_reg <= 128
    assert geo.rows_smem % 4 == 0 and geo.rows_smem > 0
    # a thread per column, a whole number of warps, and a gate thread per
    # state element of the group
    assert geo.threads == 4 * geo.S == geo.G * geo.S
    assert geo.threads % 32 == 0 and geo.threads <= 1024
    assert geo.smem_bytes == 4 * (geo.rows_smem * 4 * geo.S
                                  + 2 * geo.G * P + geo.G * 4 * geo.S) + 16
    groups = geo.batch_rows(B)
    assert len(groups) == geo.groups == -(-B // geo.G)
    rows = [b for b0, nb in groups for b in range(b0, b0 + nb)]
    assert rows == list(range(B))
    assert all(1 <= nb <= geo.G for _, nb in groups)
    assert geo.c_args() == (geo.C, geo.G, geo.rows_reg, geo.threads,
                            geo.smem_bytes)


def test_geometry_of_the_serving_shape_and_refusals():
    """xlstm-350m (P = 512, B = 4): one cluster of 16 per head, rows 0-127
    in registers, 128-511 (192 KiB) in shared memory."""
    geo = slstm_mod.geometry(512, 4)
    assert (geo.C, geo.G, geo.threads, geo.groups) == (16, 4, 128, 1)
    assert (geo.rows_reg, geo.rows_smem) == (128, 384)
    assert geo.smem_bytes == 196_608 + 16_384 + 2_048 + 16
    for P, B in ((64, 4), (6, 1), (512, 0)):
        with pytest.raises(ValueError, match="no geometry"):
            slstm_mod.geometry(P, B)


# ---------------------------------------------------------------------------
# the model's blocks
# ---------------------------------------------------------------------------

def _cfgs(chunk=0):
    jcfg = dataclasses.replace(jreduced(jget_arch("xlstm-350m")),
                               xlstm_chunk=chunk)
    cfg = dataclasses.replace(reduced(get_arch("xlstm-350m")),
                              xlstm_chunk=chunk)
    return jcfg, cfg


def _block(init, seed):
    """The reference's block weights (with non-zero norms, so that every
    parameter matters) and the same numbers as torch tensors."""
    jcfg, _ = _cfgs()
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    for name in ("ln", "norm"):
        jp = dict(jp, **{name: jnp.asarray(rng.normal(
            size=jp[name].shape).astype(np.float32) * 0.1)})
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_slstm_forward_matches_reference_on_both_routes():
    """The port's counterpart of tests/test_kernels.py::
    test_slstm_ref_matches_model_scan: the port's ``slstm_forward`` (the
    scan route with no gradient, the plain loop with one) equals the
    reference's ``slstm_forward``, whose scan is inline."""
    jcfg, cfg = _cfgs()
    jp, p = _block(jxlstm.init_slstm, seed=4)
    x = np.random.default_rng(1).normal(size=(2, 20, cfg.d_model)).astype(
        np.float32)
    want, jst = jxlstm.slstm_forward(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, st = xlstm.slstm_forward(p, torch.from_numpy(x), cfg)
    grad_p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    got_g, st_g = xlstm.slstm_forward(grad_p, torch.from_numpy(x), cfg)
    for out, state in ((got, st), (got_g.detach(), st_g)):
        _close(out, want, ATOL)
        for a, b in zip(state, jst):
            _close(a.detach(), b, ATOL)
    got_g.sum().backward()
    assert all(v.grad is not None for v in grad_p.values())


def test_slstm_forward_chunk_and_decode_carry_the_state_in_place():
    jcfg, cfg = _cfgs()
    jp, p = _block(jxlstm.init_slstm, seed=5)
    x = np.random.default_rng(2).normal(size=(2, 33, cfg.d_model)).astype(
        np.float32)
    state = xlstm.init_slstm_state(cfg, 2, device="cpu")
    jst = None
    for part in (x[:, :20], x[:, 20:32], x[:, 32:]):
        jout, jst = jxlstm.slstm_forward(jp, jnp.asarray(part), jcfg, jst)
        with torch.no_grad():
            out, new = xlstm.slstm_forward(p, torch.from_numpy(part), cfg,
                                           state)
        assert new is state
        _close(out, jout, ATOL)
        for a, b in zip(state, jst):
            _close(a, b, ATOL)


def test_slstm_routes_by_gradient(monkeypatch):
    """With no gradient recorded the recurrence goes through
    ``ops.slstm_scan`` (the kernel on a card), decode steps included; with
    one recorded through the plain ``slstm_steps_ref``."""
    _, cfg = _cfgs()
    _, p = _block(jxlstm.init_slstm, seed=6)
    calls = []
    real_scan, real_plain = ops.slstm_scan, xlstm.slstm_steps_ref

    def spy(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(xlstm.slstm_ops, "slstm_scan", spy("kernel",
                                                           real_scan))
    monkeypatch.setattr(xlstm, "slstm_steps_ref", spy("plain", real_plain))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 9, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        _, st = xlstm.slstm_forward(p, x, cfg)
        xlstm.slstm_forward(p, x[:, :1], cfg, st)
    assert calls == ["kernel", "kernel"]
    grad_p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xlstm.slstm_forward(grad_p, x, cfg)
    assert calls == ["kernel", "kernel", "plain"]



@pytest.mark.parametrize("chunk", [0, 8, 16])
def test_mlstm_forward_matches_reference(chunk):
    """Prefill from scratch, a chunk with the carried state and a decode
    step, on the per-step branch (chunk 0) and the chunked one (ragged
    last chunks: 23 and 12 tokens in chunks of 8 and 16); the state is
    written in place."""
    jcfg, cfg = _cfgs(chunk)
    jp, p = _block(jxlstm.init_mlstm, seed=7)
    x = np.random.default_rng(4).normal(size=(2, 36, cfg.d_model)).astype(
        np.float32)
    first, second, step = x[:, :23], x[:, 23:35], x[:, 35:]
    jout, jst = jxlstm.mlstm_forward(jp, jnp.asarray(first), jcfg)
    with torch.no_grad():
        out, st = xlstm.mlstm_forward(p, torch.from_numpy(first), cfg)
    _close(out, jout, ATOL)
    state = xlstm.init_mlstm_state(cfg, 2, device="cpu")
    for dst, src in zip(state, st):
        dst.copy_(src)
    for part in (second, step):
        jout, jst = jxlstm.mlstm_forward(jp, jnp.asarray(part), jcfg, jst)
        with torch.no_grad():
            out, new = xlstm.mlstm_forward(p, torch.from_numpy(part), cfg,
                                           state)
        assert new is state
        _close(out, jout, ATOL)
        for a, b in zip(state, jst):
            _close(a, b, ATOL)


def test_mlstm_chunked_equals_per_step_and_has_a_gradient():
    """The port's two branches agree (as the reference's
    tests/test_perf_variants.py pins for its own), and the chunked one
    differentiates."""
    _, cfg0 = _cfgs(0)
    _, cfg16 = _cfgs(16)
    _, p = _block(jxlstm.init_mlstm, seed=8)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 40, cfg0.d_model)).astype(np.float32))
    with torch.no_grad():
        a, sa = xlstm.mlstm_forward(p, x, cfg0)
        b, sb = xlstm.mlstm_forward(p, x, cfg16)
    _close(b, a, ATOL)
    for u, v in zip(sb, sa):
        _close(u, v, ATOL)
    grad_p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xlstm.mlstm_forward(grad_p, x, cfg16)[0].sum().backward()
    assert all(v.grad is not None for v in grad_p.values())


def test_init_and_states_match_reference():
    """Parameter names, shapes and dtypes (the gates fp32 in a bf16
    model), and the fresh states: mLSTM (C, n, m) with m at -1e30, sLSTM
    (c, n, h, m) with n at 1e-6 and m at -1e30."""
    jcfg, cfg = _cfgs()
    for jinit, init in ((jxlstm.init_mlstm, xlstm.init_mlstm),
                        (jxlstm.init_slstm, xlstm.init_slstm)):
        want = jax.eval_shape(lambda k: jinit(k, jcfg, jnp.bfloat16),
                              jax.random.PRNGKey(0))
        got = init(None, cfg, torch.bfloat16, device="meta")
        assert sorted(got) == sorted(want)
        for name, leaf in got.items():
            assert tuple(leaf.shape) == want[name].shape, name
            assert str(leaf.dtype).removeprefix("torch.") == \
                want[name].dtype.name, name
    ref = jxlstm.init_slstm(jax.random.PRNGKey(0), jcfg, jnp.float32)
    port = xlstm.init_slstm(torch.Generator().manual_seed(0), cfg,
                            torch.float32, device="cpu")
    _close(port["b_gates"], ref["b_gates"], 0)
    from repro.models import transformer as jlm
    from repro_torch.models import transformer as lm
    for kind in ("mlstm", "slstm"):
        want = jlm._block_state(kind, jcfg, 3, 8, jnp.float32)
        got = lm._block_state(kind, cfg, 3, 8, torch.float32, device="cpu")
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the wrapper's checks
# ---------------------------------------------------------------------------

def _z(d, *shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=d)


def _st(d, B, H, P, dtype=torch.float32):
    return tuple(_z(d, B, H, P, dtype=dtype) for _ in range(4))


@pytest.mark.parametrize("make, err, match", [
    (lambda d: (_z(d, 1, 4, 2, 64)[0], _z(d, 2, 16, 64), _st(d, 1, 2, 16)),
     ValueError, "4-D"),
    (lambda d: (_z(d, 1, 4, 2, 64), _z(d, 2, 16, 64),
                _st(d, 1, 2, 16)[:3]), ValueError, "four tensors"),
    (lambda d: (_z(d, 1, 4, 2, 64, dtype=torch.bfloat16), _z(d, 2, 16, 64),
                _st(d, 1, 2, 16)), TypeError, "float32"),
    (lambda d: (_z(d, 1, 4, 2, 64), _z(d, 2, 16, 64),
                _st(d, 1, 2, 16, dtype=torch.float64)), TypeError,
     "float32"),
    (lambda d: (_z(d, 1, 4, 2, 64), _z(d, 2, 16, 60), _st(d, 1, 2, 16)),
     ValueError, "do not agree"),
    (lambda d: (_z(d, 1, 4, 2, 64), _z(d, 2, 16, 64), _st(d, 2, 2, 16)),
     ValueError, "do not agree"),
    (lambda d: (_z(d, 1, 0, 2, 64), _z(d, 2, 16, 64), _st(d, 1, 2, 16)),
     ValueError, "T >= 1"),
    (lambda d: (_z(d, 1, 4, 2, 256), _z(d, 2, 64, 256), _st(d, 1, 2, 64)),
     ValueError, "head dim P = 64"),
    (lambda d: (_z(d, 1, 4, 2, 24), _z(d, 2, 6, 24), _st(d, 1, 2, 6)),
     ValueError, "head dim P = 6"),
    (lambda d: (_z(d, 1, 4, 2, 128)[..., ::2], _z(d, 2, 16, 64),
                _st(d, 1, 2, 16)), ValueError, "contiguous"),
    (lambda d: (_z(d, 1, 4, 2, 64), _z(d, 2, 64, 16).transpose(1, 2),
                _st(d, 1, 2, 16)), ValueError, "contiguous"),
], ids=["rank", "state-arity", "dtype", "state-dtype", "R-shape",
        "state-shape", "empty", "P-64", "P-6", "strided", "R-strided"])
def test_guards_raise_before_dispatch_and_build(monkeypatch, make, err,
                                                match):
    """Bad inputs raise on either device (meta stands in for a card)
    before any dispatch, launch or kernel build."""
    def no_build():
        raise AssertionError("build() reached")
    monkeypatch.setattr(slstm_mod, "build", no_build)
    LAUNCHES["slstm_steps"] = 0
    for device in ("cpu", "meta"):
        with pytest.raises(err, match=match):
            slstm_steps(*make(device))
        with pytest.raises(err, match=match):
            slstm_scan(*make(device))
    assert LAUNCHES["slstm_steps"] == 0
    assert "slstm_step" not in _build._libs


def test_guards_unsupported_device_mixed_devices_and_gradient(monkeypatch):
    def no_build():
        raise AssertionError("build() reached")
    monkeypatch.setattr(slstm_mod, "build", no_build)
    with pytest.raises(ValueError, match="unsupported device"):
        slstm_steps(_z("meta", 1, 4, 2, 64), _z("meta", 2, 16, 64),
                    _st("meta", 1, 2, 16))
    with pytest.raises(ValueError, match="different devices"):
        slstm_steps(_z("meta", 1, 4, 2, 64), _z("cpu", 2, 16, 64),
                    _st("cpu", 1, 2, 16))
    g = _z("cpu", 1, 4, 2, 64).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        slstm_steps(g, _z("cpu", 2, 16, 64), _st("cpu", 1, 2, 16))
    with torch.no_grad():
        slstm_steps(g, _z("cpu", 2, 16, 64), _st("cpu", 1, 2, 16))
    assert HEAD_DIMS == (8, 16, 32, 128, 512)


def test_every_cuda_source_is_listed_for_the_build():
    """``kernels/_build.py`` lists the module of every ``csrc/*.cu`` of the
    port, so ``chip_smoke.py`` builds all of them at once."""
    root = pathlib.Path(_build.__file__).resolve().parent
    sources = sorted(p.relative_to(root).as_posix()
                     for p in root.glob("*/csrc/*.cu"))
    listed = sorted(s.path.relative_to(root).as_posix()
                    for s in _build.all_sources())
    assert listed == sources
    assert "slstm_step/csrc/slstm_step.cu" in listed
