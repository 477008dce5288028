"""``pullpush_fused`` on a worker-stacked tree's own leaves, against the JAX
package's ``pullpush_fused`` (its Pallas ``fused_round`` in interpret mode)
on the same numpy inputs, and the pieces that the two leaf kernels of
``csrc/pullpush.cu`` rest on: the host-side leaf table, the guards, and the
fixed-order sum of block partials that the partial-Gram kernel's tail (and
``gram_coef``) runs.

On the CPU the kernel route runs its plain version (the leaves flattened
into one fp32 view, ``fused_round_plain``, each leaf cast back). The
reference's Gram is block-centered over other blocks, so the two packages
part by fp32 rounding: fp32 leaves within 1e-5, bf16 leaves within one
bf16 ulp of the leaf's scale (a value near a rounding boundary may round
either way), r within 1e-5. The kernels themselves are held bit for bit
against the flattened composite on the card by ``chip_smoke.py``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.kernels.pullpush import pullpush_fused as jpullpush_fused
from repro.models import build_model as jbuild_model
from repro_torch.core.engine import (
    ConsensusEngine, tree_from_items, tree_items,
)
from repro_torch.kernels.pullpush import pullpush as pk
from repro_torch.kernels.pullpush import ref
from repro_torch.kernels.pullpush import pullpush_fused
from test_torch_kernels import bf16_ulp

ALPHA, LAM = 0.1, 0.5

# leaf shapes (without the worker dim) and dtypes: sizes 15, 7, 66, 1, 101
# (none a multiple of 4), and a tree whose n is a multiple of 4 though no
# leaf size is (6 + 10 + 1 + 3 + 4 = 24)
TREES = {
    "ragged": {"a": ((3, 5), "bfloat16"), "b": ((7,), "float32"),
               "c": ((33, 2), "bfloat16"), "d": ((1,), "float32"),
               "e": ((101,), "bfloat16")},
    "n4": {"a": ((6,), "float32"), "b": ((2, 5), "bfloat16"),
           "c": ((1,), "bfloat16"), "d": ((3,), "float32"),
           "e": ((4,), "bfloat16")},
}


def _trees(spec, M, seed):
    """(jax tree, torch tree) of M workers around one model (spread 0.3),
    each leaf in its dtype with the same values in both packages."""
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for k, (shape, dtype) in spec.items():
        v = (rng.normal(size=shape)[None]
             + 0.3 * rng.normal(size=(M,) + shape)).astype(np.float32)
        j[k] = jnp.asarray(v, getattr(jnp, dtype))
        t[k] = torch.from_numpy(np.array(j[k].astype(jnp.float32))).to(
            getattr(torch, dtype))
    return j, t


def _close(got, want, what):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape, what
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=bf16_ulp(np.abs(w).max()),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=what)


# ---------------------------------------------------------------------------
# pullpush_fused against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("M", [2, 4, 8, 16])
def test_pullpush_fused_leaves_match_reference(tree, M):
    jstacked, stacked = _trees(TREES[tree], M, seed=M)
    want, jr = jpullpush_fused(jstacked, ALPHA, LAM)
    got, r = pullpush_fused(stacked, ALPHA, LAM)
    for k in jstacked:
        assert got[k].dtype == stacked[k].dtype
        assert got[k].shape == stacked[k].shape
        _close(got[k], want[k], f"leaf {k}")
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5)


def test_pullpush_fused_reduced_yi6b_matches_reference():
    """The slice as a whole: reduced yi-6b's tree (its matrices in bf16,
    its norms in fp32), M = 4 workers around the reference's init."""
    M = 4
    params = jax.jit(jbuild_model(jreduced(jget_arch("yi-6b"))).init)(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    jitems, titems = [], []
    for path, leaf in flat:
        v = np.asarray(leaf, np.float32)
        v = v[None] + 0.01 * rng.normal(size=(M,) + v.shape).astype(
            np.float32)
        key = tuple(getattr(k, "key", k) for k in path)
        norm = any("ln" in str(k) or "norm" in str(k) for k in key)
        dt = "float32" if norm else "bfloat16"
        jv = jnp.asarray(v, getattr(jnp, dt))
        jitems.append((key, jv))
        titems.append((key, torch.from_numpy(np.array(
            jv.astype(jnp.float32))).to(getattr(torch, dt))))
    jstacked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), [v for _, v in jitems])
    stacked = tree_from_items(titems)
    assert {str(l.dtype) for _, l in titems} == {"torch.float32",
                                                 "torch.bfloat16"}
    want, jr = jpullpush_fused(jstacked, ALPHA, LAM)
    got, r = pullpush_fused(stacked, ALPHA, LAM)
    wflat = {tuple(getattr(k, "key", k) for k in p): v for p, v in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    for path, leaf in tree_items(got):
        _close(leaf, wflat[path], str(path))
    # r to 1e-4 here (tests/test_engine.py's fused-kernel bar): the plain
    # version's Gram is one fp32 GEMM over 1.44 M columns, whose running
    # sums put its r 2.0e-5 from the fp64 distance (the reference's
    # per-block sums: 8e-7)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-4)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_leaves_plain_is_the_flattened_composite(tree):
    """The kernels' plain version is the engine's flatten, one
    ``fused_round_plain`` and the engine's unflatten, bit for bit."""
    _, stacked = _trees(TREES[tree], 4, seed=3)
    leaves = [l for _, l in tree_items(stacked)]
    T = torch.full((4, 4), 0.25)
    c0, c1 = torch.full((4,), ALPHA), torch.full((4,), -LAM)
    got, r, G = pk.fused_round_leaves(leaves, T, c0, c1)
    eng = ConsensusEngine.from_stacked(stacked, use_kernel=True)
    flat = eng.flatten(stacked)
    out, r_want, G_want = ref.fused_round_plain(flat, T, c0, c1, out=flat)
    want = [l for _, l in tree_items(eng.unflatten(out))]
    assert torch.equal(r, r_want) and torch.equal(G, G_want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# the leaf table and the guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree, M", [("ragged", 4), ("n4", 4), ("n4", 8),
                                     ("n4", 16), ("ragged", 2)])
def test_leaf_table_lays_out_the_flatten_order(tree, M):
    """Offsets and sizes are the engine's layout; the dtype flags the
    leaves'; VEC is ``_vec`` of the flattened fp32 view."""
    _, stacked = _trees(TREES[tree], M, seed=1)
    leaves = [l for _, l in tree_items(stacked)]
    table = pk.leaf_table(leaves)
    eng = ConsensusEngine.from_stacked(stacked)
    assert (table.M, table.n) == (M, eng.layout.n)
    assert table.offsets == eng.layout.offsets
    assert table.sizes == eng.layout.sizes
    assert table.bf16 == tuple(int(l.dtype == torch.bfloat16)
                               for l in leaves)
    assert table.vec == pk._vec(eng.flatten(stacked))
    outs = [torch.empty_like(l) for l in leaves]
    rows = table.packed(leaves, outs)
    assert rows.dtype == torch.int64
    assert rows.shape == (len(leaves), pk.LEAF_FIELDS)
    assert rows[:, 0].tolist() == [l.data_ptr() for l in leaves]
    assert rows[:, 1].tolist() == [o.data_ptr() for o in outs]
    assert rows[:, 2].tolist() == list(table.sizes)
    assert rows[:, 3].tolist() == list(table.offsets)
    assert rows[:, 4].tolist() == list(table.bf16)


def test_leaf_table_skips_empty_leaves():
    leaves = [torch.zeros((4, 3)), torch.zeros((4, 0)),
              torch.zeros((4, 5), dtype=torch.bfloat16)]
    table = pk.leaf_table(leaves)
    assert table.sizes == (3, 0, 5) and table.offsets == (0, 3, 3)
    rows = table.packed(leaves, leaves)
    assert rows[:, 2].tolist() == [3, 5] and rows[:, 3].tolist() == [0, 3]
    got, _ = pullpush_fused({"a": leaves[0], "b": leaves[1],
                             "c": leaves[2]}, ALPHA, LAM)
    assert got["b"].shape == (4, 0)


@pytest.mark.parametrize("leaves, err", [
    ([torch.zeros((4, 8)), torch.zeros((4, 3), dtype=torch.float16)],
     TypeError),
    ([torch.zeros((4, 8)), torch.zeros((4, 3), device="meta")], ValueError),
    ([torch.zeros((33, 8))], ValueError),                          # M > 32
    ([torch.zeros((4, 8)), torch.zeros((3, 8))], ValueError),       # M differs
    ([torch.zeros((4, 0))], ValueError),                           # no columns
])
def test_pullpush_fused_guards(leaves, err, monkeypatch):
    """Bad trees raise before any build or launch."""
    def no_build():
        raise AssertionError("build() reached")
    monkeypatch.setattr(pk, "build", no_build)
    stacked = {f"l{i}": l for i, l in enumerate(leaves)}
    with pytest.raises(err):
        pullpush_fused(stacked, ALPHA, LAM)
    with pytest.raises(err):
        pk.fused_round_leaves(leaves, 0.25, ALPHA, -LAM)


def test_pullpush_fused_on_cpu_launches_nothing():
    pk.reset_launches()
    _, stacked = _trees(TREES["ragged"], 4, seed=2)
    pullpush_fused(stacked, ALPHA, LAM)
    assert all(v == 0 for v in pk.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the fixed-order sum of block partials
# ---------------------------------------------------------------------------

def _kernel_order_sum(ws):
    """gram_coef_kernel's sum, slot by slot as its threads run it."""
    nblk, R, _ = ws.shape
    RR = R * R
    C = max(ref.COEF_THREADS // RR, 1)
    w = ws.reshape(nblk, RR).numpy()
    part = np.zeros((C, RR), np.float32)
    for t in range(RR * C):
        entry, chunk = t % RR, t // RR
        s = np.float32(0)
        for b in range(chunk, nblk, C):
            s = np.float32(s + w[b, entry])
        part[chunk, entry] = s
    G = np.zeros(RR, np.float32)
    for e in range(RR):
        s = np.float32(0)
        for ch in range(C):
            s = np.float32(s + part[ch, e])
        G[e] = s
    return torch.from_numpy(G.reshape(R, R))


@pytest.mark.parametrize("nblk, R", [(1, 4), (7, 5), (1056, 4), (1056, 8),
                                     (33, 32), (3, 1)])
def test_gram_sum_plain_is_the_kernel_order(nblk, R):
    """``gram_sum_plain`` (the tail's and ``gram_coef``'s order) against a
    slot-by-slot emulation of the kernel (bit for bit) and against
    ``ws.sum(0)`` and an fp64 sum (fp32 rounding)."""
    rng = np.random.default_rng(nblk * R)
    ws = torch.from_numpy(rng.normal(size=(nblk, R, R)).astype(np.float32))
    got = ref.gram_sum_plain(ws)
    assert torch.equal(got, _kernel_order_sum(ws))
    exact = ws.double().sum(0)
    scale = float(ws.abs().sum(0).max())
    assert float((got.double() - exact).abs().max()) <= 1e-6 * scale
    np.testing.assert_allclose(got.numpy(), ws.sum(0).numpy(),
                               rtol=1e-5, atol=1e-6 * scale)
    T = torch.full((R, R), 1.0 / R)
    G, _, _ = pk.gram_coef(ws, T, ALPHA, -LAM)
    assert torch.equal(G, got)
