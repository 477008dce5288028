"""The port's pull-push consensus kernels against the JAX package.

On the CPU every wrapper in ``repro_torch.kernels.pullpush`` runs its plain
PyTorch version; these tests hold those versions against the reference's
Pallas kernels (interpret mode) and its jnp oracle on the same numpy
inputs. The CUDA kernels themselves are held against the same plain
versions on the card by ``chip_smoke.py``.

G is block-centered in both packages, but over different blocks, so only
its zero-sum quadratic forms are compared: the pre distances
(``V = I - 1/R``) and the post distances (``V (I + diag(coef)(T - I))``).
"""
from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pullpush import (
    apply_update as jax_apply_update, fused_round as jax_fused_round,
    fused_round_ref as jax_fused_round_ref, sq_dist as jax_sq_dist,
)
from repro_torch.kernels import _build
from repro_torch.kernels.pullpush import pullpush as pk
from repro_torch.kernels.pullpush import ref

TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_engine.py fused-kernel tol


def _inputs(R, n, seed=0):
    rng = np.random.default_rng(seed)
    flat = (rng.normal(size=(R, n)) * 2.0 + 1.0).astype(np.float32)
    z = np.exp(rng.normal(size=(R, R)))
    T = (z / z.sum(axis=1, keepdims=True)).astype(np.float32)
    c0 = np.linspace(0.1, 0.5, R, dtype=np.float32)
    c1 = np.linspace(-0.4, -0.1, R, dtype=np.float32)
    return flat, T, c0, c1


def _zero_sum_forms(G, T, coef):
    """Pre and post distance forms of a Gram (float64)."""
    G = np.asarray(G, np.float64)
    T = np.asarray(T, np.float64)
    R = G.shape[0]
    eye = np.eye(R)
    Vu = eye - np.full((R, R), 1.0 / R)
    W = eye + np.asarray(coef, np.float64)[:, None] * (T - eye)
    form = lambda V: np.sum((V @ G) * V, axis=1)
    return form(Vu), form(Vu @ W)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", [(4, 300), (8, 4097), (3, 128)])
def test_fused_round_plain_matches_jax(shape):
    R, n = shape
    flat, T, c0, c1 = _inputs(R, n, seed=R * n)
    out, r, G = pk.fused_round(_t(flat), _t(T), _t(c0), _t(c1))
    j_out, j_r, j_G = jax_fused_round(jnp.asarray(flat), jnp.asarray(T),
                                      jnp.asarray(c0), jnp.asarray(c1),
                                      block_cols=256)
    o_out, o_r = jax_fused_round_ref(jnp.asarray(flat), jnp.asarray(T),
                                     jnp.asarray(c0), jnp.asarray(c1))
    for want_out, want_r in ((j_out, j_r), (o_out, o_r)):
        np.testing.assert_allclose(r.numpy(), np.asarray(want_r), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    coef = c0 + c1 / np.maximum(r.numpy(), 1e-12)
    for got, want in zip(_zero_sum_forms(G.numpy(), T, coef),
                         _zero_sum_forms(np.asarray(j_G), T, coef)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_fused_round_plain_centered_gram_is_cancellation_safe():
    """Workers clustered far from the origin (tests/test_engine.py): the
    block-centered Gram keeps relative distance error ~1e-6."""
    rng = np.random.default_rng(2)
    n, M = 4096, 4
    base = rng.normal(size=n) * 3.0 + 5.0
    flat = (base[None] + 0.05 * rng.normal(size=(M, n))).astype(np.float32)
    T = np.full((M, M), 1.0 / M, np.float32)
    _, r, _ = pk.fused_round(_t(flat), _t(T), 0.0, 0.0)
    f64 = flat.astype(np.float64)
    r_true = np.sqrt(((f64 - f64.mean(0)) ** 2).sum(1))
    np.testing.assert_allclose(r.numpy(), r_true, rtol=1e-5)


def test_partial_gram_plus_mix_match_fused_round():
    """Column shards (tests/test_sharded_round.py): summed partial Grams +
    coefficients + per-shard mixes equal the fused stage."""
    R, n = 5, 1000
    flat, T, c0, c1 = _inputs(R, n, seed=1)
    want, r_want = jax_fused_round_ref(jnp.asarray(flat), jnp.asarray(T),
                                       jnp.asarray(c0), jnp.asarray(c1))
    got_fused, r_fused, _ = pk.fused_round(_t(flat), _t(T), _t(c0), _t(c1))
    shards = torch.chunk(_t(flat), 4, dim=1)
    ws = torch.stack([pk.partial_gram(s.contiguous()) for s in shards])
    _, r, coef = pk.gram_coef(ws, _t(T), _t(c0), _t(c1))
    out = torch.cat([pk.mix_shard(s.contiguous(), _t(T), coef)
                     for s in shards], dim=1)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_want), rtol=1e-4)
    np.testing.assert_allclose(r.numpy(), r_fused.numpy(), rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out.numpy(), got_fused.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_on_cpu_take_the_plain_version():
    R, n = 4, 300
    flat, T, c0, c1 = (_t(a) for a in _inputs(R, n))
    pk.reset_launches()
    out, r, G = pk.fused_round(flat, T, c0, c1)
    p_out, p_r, p_G = ref.fused_round_plain(flat, T, c0, c1)
    assert torch.equal(out, p_out) and torch.equal(r, p_r) \
        and torch.equal(G, p_G)
    assert torch.equal(pk.partial_gram(flat), ref.partial_gram_plain(flat))
    coef = c0 + c1 / r
    assert torch.equal(pk.mix_shard(flat, T, coef),
                       ref.mix_shard_plain(flat, T, coef))
    # in place: out=flat gives the same stage
    inplace = flat.clone()
    res, _, _ = pk.fused_round(inplace, T, c0, c1, out=inplace)
    assert res.data_ptr() == inplace.data_ptr()
    assert torch.equal(inplace, p_out)
    assert all(v == 0 for v in pk.LAUNCHES.values())
    assert "pullpush" not in _build._libs   # nothing built for the CPU path


@pytest.mark.parametrize("bad, err", [
    (lambda: torch.zeros((33, 64)), ValueError),                # R > 32
    (lambda: torch.zeros((4, 64), dtype=torch.float64), TypeError),
    (lambda: torch.zeros((4, 128))[:, ::2], ValueError),        # strided
    (lambda: torch.zeros((64,)), ValueError),                   # not (R, n)
])
def test_fused_round_guards(bad, err):
    flat = bad()
    R = flat.shape[0]
    T = torch.full((R, R), 1.0 / R)
    with pytest.raises(err):
        pk.fused_round(flat, T, 0.1, -0.5)


def test_out_must_be_flat_or_another_buffer():
    buf = torch.ones((5, 64))
    T = torch.full((4, 4), 0.25)
    with pytest.raises(ValueError, match="another buffer"):
        pk.fused_round(buf[:4], T, 0.1, -0.5, out=buf[1:])
    with pytest.raises(ValueError, match="another buffer"):
        pk.mix_shard(buf[:4], T, torch.zeros(4), out=buf[1:])


def test_guards_run_before_dispatch_and_build(monkeypatch):
    """A bad input raises before any device dispatch or kernel build, and
    a CUDA call with no nvcc reports the missing compiler."""
    def no_build():
        raise AssertionError("build() reached")
    monkeypatch.setattr(pk, "build", no_build)
    with pytest.raises(ValueError):
        pk.fused_round(torch.zeros((40, 8), device="meta"),
                       torch.zeros((40, 40)), 0.0, 0.0)
    with pytest.raises(ValueError):
        pk.mix_shard(torch.zeros((4, 16), device="meta")[:, ::2],
                     torch.zeros((4, 4)), torch.zeros(4))
    # a good meta input reaches the meta branch (launch analysis): an
    # empty output, nothing built or launched
    before = dict(pk.LAUNCHES)
    out = pk.mix_shard(torch.zeros((4, 8), device="meta"),
                       torch.zeros((4, 4)), torch.zeros(4))
    assert out.device.type == "meta" and out.shape == (4, 8)
    assert pk.LAUNCHES == before
    monkeypatch.undo()
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "no-such-dir")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pk.build()


def test_build_keeps_the_compiler_report_for_a_reused_library(
        monkeypatch, tmp_path):
    """A library built in an earlier process is reused, and its ptxas
    report still reaches ``build_info`` (chip_smoke.py reads registers and
    spills from it). A stand-in nvcc copies a shared library that loads
    anywhere torch does (torch's own extension module)."""
    import sys
    lib = torch._C.__file__
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport shutil, sys\n"
        f"shutil.copy({lib!r}, sys.argv[sys.argv.index('-o') + 1])\n"
        "print('ptxas info    : Used 42 registers, used 1 barriers')\n")
    fake.chmod(0o755)
    cu = tmp_path / "k.cu"
    cu.write_text("// stand-in source\n")
    src = _build.Source("stand_in", cu, lambda lib: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    for fresh in (True, False):        # built, then reused
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "build_info", {})
        _build.build(src)
        assert _build._target(src).exists()
        assert "Used 42 registers" in _build.build_info["stand_in"]["log"]
    assert len(list((tmp_path / "build").glob("*.log"))) == 1


def test_build_compiles_a_source_in_parts_then_links_them(monkeypatch,
                                                         tmp_path):
    """A ``Source`` of several parts: one ``nvcc -c -DKERNEL_PART=k`` a
    part, then one link of their objects into the library; the objects are
    removed and the log holds every part's compiler report. A stand-in
    nvcc writes each object and copies torch's extension module as the
    linked library."""
    import json
    import sys
    lib = torch._C.__file__
    calls = tmp_path / "calls.jsonl"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\nimport json, shutil, sys\n"
        "a = sys.argv[1:]\nout = a[a.index('-o') + 1]\n"
        f"open({str(calls)!r}, 'a').write(json.dumps(a) + '\\n')\n"
        "if '-c' in a:\n"
        "    part = [f for f in a if f.startswith('-DKERNEL_PART=')][0]\n"
        "    open(out, 'w').write(part)\n"
        "    print('ptxas info    : Used 9 registers', part)\n"
        f"else:\n    shutil.copy({lib!r}, out)\n")
    fake.chmod(0o755)
    cu = tmp_path / "k.cu"
    cu.write_text("// stand-in source\n")
    src = _build.Source("stand_in_parts", cu, lambda lib: None, parts=3)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_info", {})
    _build.build(src)
    argvs = [json.loads(line) for line in calls.read_text().splitlines()]
    compiles, link = argvs[:-1], argvs[-1]
    assert sorted(next(f for f in a if f.startswith("-DKERNEL_PART="))
                  for a in compiles) == [f"-DKERNEL_PART={k}"
                                         for k in range(3)]
    assert all("-c" in a and "-shared" not in a for a in compiles)
    objs = [a[a.index("-o") + 1] for a in compiles]
    assert link[0] == "-shared" and sorted(link[3:]) == sorted(objs)
    assert _build._target(src).exists()
    assert not any(os.path.exists(o) for o in objs)
    info = _build.build_info["stand_in_parts"]
    for k in range(3):
        assert f"-DKERNEL_PART={k}" in info["log"]
    assert info["nvcc_seconds"] > 0
    # one part is the default, and the part count names another library
    assert _build._target(dataclasses.replace(src, parts=1)) \
        != _build._target(src)


def test_pullpush_parts_hold_each_entry_point_once():
    """pullpush.cu's ``PP_PARTS`` is the ``SOURCE``'s part count, and every
    entry point ``_bind`` binds lies in exactly one part (each part holds
    some): a part that lost one would link a library without it."""
    import re
    text = pk.SOURCE.path.read_text()
    assert int(re.search(r"#define PP_PARTS (\d+)", text).group(1)) \
        == pk.SOURCE.parts == 5
    body = text[text.index('extern "C" {'):]
    where = {}
    for k, block in re.findall(r"#if PP_IN\((\d+)\)\n(.*?)#endif", body,
                               re.S):
        for name in re.findall(r"^(?:int|const char\*) (pp_\w+)\(", block,
                               re.M):
            where.setdefault(name, []).append(int(k))
    bound = set(re.findall(r"lib\.(pp_\w+)",
                           open(pk.__file__).read()))
    assert set(where) == bound
    assert all(len(v) == 1 for v in where.values()), where
    assert sorted({v[0] for v in where.values()}) == list(range(5))


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing the kernel module builds nothing: a fresh interpreter
    with no nvcc on PATH imports it and runs the CPU path."""
    import subprocess
    import sys
    code = ("import sys, torch\n"
            "from repro_torch.kernels.pullpush import pullpush as pk\n"
            "x = torch.ones((2, 8)); T = torch.full((2, 2), 0.5)\n"
            "pk.fused_round(x, T, 0.1, 0.0)\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._libs and not _build.build_info\n"
            "print('ok')\n")
    env = {"PATH": str(tmp_path), "PYTHONPATH": ":".join(sys.path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# sq_dist / apply_update: the tree path's per-vector pair
# ---------------------------------------------------------------------------

# (x dtype, a dtype): fp32, bf16, and a bf16 worker leaf against the fp32
# center as the tree path passes them
PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("bfloat16", "float32")]


def _pair(n, xd, ad, seed):
    """Normal x and a, rounded to their dtypes once in jnp so that both
    packages see the same values."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=n), getattr(jnp, xd))
    a = jnp.asarray(rng.normal(size=n), getattr(jnp, ad))
    to_t = lambda v, d: torch.from_numpy(
        np.array(v.astype(jnp.float32))).to(getattr(torch, d))
    return x, a, to_t(x, xd), to_t(a, ad)


def bf16_ulp(scale):
    """One bf16 ulp at ``scale``: 8 significant bits."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("n", [128, 1000, 32768, 40001])
@pytest.mark.parametrize("xd, ad", PAIRS)
def test_sq_dist_plain_matches_jax(n, xd, ad):
    """The same numbers summed in fp32 in another order: rtol 1e-5."""
    jx, ja, x, a = _pair(n, xd, ad, seed=n)
    want = float(jax_sq_dist(jx, ja))
    got = ref.sq_dist_plain(x, a)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("n", [256, 5000, 33000])
@pytest.mark.parametrize("xd, ad", PAIRS)
def test_apply_plain_matches_jax(n, xd, ad):
    """fp32 within 1e-6; bf16 outputs within one bf16 ulp of the output's
    scale."""
    jx, ja, x, a = _pair(n, xd, ad, seed=n + 7)
    coef = 0.1 - 0.5 / 3.0
    want = np.asarray(jax_apply_update(jx, ja, coef).astype(jnp.float32))
    got = ref.apply_plain(x, a, coef)
    assert got.dtype == x.dtype
    atol = 1e-6 if xd == "float32" else bf16_ulp(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=atol)


def test_pair_wrappers_on_cpu_take_the_plain_version():
    _, _, x, a = _pair(1000, "bfloat16", "float32", seed=3)
    pk.reset_launches()
    assert torch.equal(pk.sq_dist(x, a), ref.sq_dist_plain(x, a))
    want = ref.apply_plain(x, a, 0.3)
    assert torch.equal(pk.apply_update(x, a, 0.3), want)
    # a one-element fp32 tensor coef, and out=x in place
    inplace = x.clone()
    res = pk.apply_update(inplace, a, torch.tensor([0.3]), out=inplace)
    assert res.data_ptr() == inplace.data_ptr()
    assert torch.equal(inplace, want)
    assert all(v == 0 for v in pk.LAUNCHES.values())
    assert "pullpush" not in _build._libs


def test_sq_dist_on_a_row_view_at_an_odd_offset():
    """A stacked leaf's row m starts at m * numel elements: row 1 of a
    (4, 231) bf16 leaf starts at an odd element."""
    rng = np.random.default_rng(5)
    leaf = torch.from_numpy(rng.normal(size=(4, 231)).astype(np.float32)
                            ).to(torch.bfloat16)
    c = torch.from_numpy(rng.normal(size=231).astype(np.float32))
    row = leaf[1]
    assert row.storage_offset() % 2 == 1 and row.is_contiguous()
    assert torch.equal(pk.sq_dist(row, c), ref.sq_dist_plain(row.clone(), c))
    want = ref.apply_plain(row.clone(), c, -0.7)
    assert torch.equal(pk.apply_update(row, c, -0.7), want)


@pytest.mark.parametrize("call, err", [
    (lambda: pk.sq_dist(torch.zeros((2, 8)), torch.zeros((2, 8))),
     ValueError),                                            # not (n,)
    (lambda: pk.sq_dist(torch.zeros(8, dtype=torch.float64),
                        torch.zeros(8)), TypeError),
    (lambda: pk.sq_dist(torch.zeros(16)[::2], torch.zeros(8)), ValueError),
    (lambda: pk.sq_dist(torch.zeros(8), torch.zeros(9)), ValueError),
    (lambda: pk.sq_dist(torch.zeros(0), torch.zeros(0)), ValueError),
    (lambda: pk.apply_update(torch.zeros(8), torch.zeros(8),
                             torch.zeros(2)), ValueError),   # coef size
    (lambda: pk.apply_update(torch.zeros(8), torch.zeros(8),
                             torch.zeros(1, dtype=torch.float64)),
     ValueError),
    (lambda: pk.apply_update(torch.zeros(8), torch.zeros(8), 0.5,
                             out=torch.zeros(8, dtype=torch.bfloat16)),
     ValueError),
])
def test_pair_guards(call, err):
    with pytest.raises(err):
        call()


def test_pair_out_must_be_x_or_another_buffer():
    buf = torch.ones(64)
    with pytest.raises(ValueError, match="another buffer"):
        pk.apply_update(buf[:32], torch.zeros(32), 0.5, out=buf[1:33])
    a = torch.zeros(32)
    with pytest.raises(ValueError, match="another buffer"):
        pk.apply_update(torch.ones(32), a, 0.5, out=a)


def test_pair_guards_run_before_dispatch_and_build(monkeypatch):
    def no_build():
        raise AssertionError("build() reached")
    monkeypatch.setattr(pk, "build", no_build)
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError):
        pk.sq_dist(meta[None], meta[None])
    with pytest.raises(ValueError):
        pk.apply_update(meta[::2], meta[::2], 0.5)
    # good meta inputs reach the meta branch: nothing built or launched
    before = dict(pk.LAUNCHES)
    assert pk.sq_dist(meta, meta).shape == ()
    assert pk.apply_update(meta, meta, 0.5).shape == (8,)
    assert pk.LAUNCHES == before
