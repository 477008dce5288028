"""The config inspector on the card's constants, the node meshes, and the
kernels' ``cost()``.

``repro_torch.launch.validate.describe`` prints the reference's
``repro/launch/validate.py`` text byte for byte when given its v5e pod
(``tp=16, hbm_gb=16.0``), for every arch; on its own constants it speaks
of H100 nodes (TP = 8, 80 GB). ``launch.mesh.make_production_mesh`` lays
out the same coordinates and groups as a real ``Mesh`` would. Each kernel
package's ``cost()`` gives, at a few shapes, the numbers the inline
reckoning of ``chip_smoke.py``'s bounds gave before it moved there (the
formulas below are that reckoning, copied).
"""
from __future__ import annotations

import contextlib
import importlib
import io
import itertools

import numpy as np
import pytest
import torch

from repro.launch import validate as jvalidate
from repro_torch.configs import ARCHS
from repro_torch.kernels.mamba_scan import mamba_scan as mk
from repro_torch.kernels.pullpush import pullpush as pk
from repro_torch.kernels.slstm_step import slstm_step as sk
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import validate

from _torch_dist import _one_torch_thread  # noqa: F401  (autouse)

# the module (the package exports the function under the same name)
swa = importlib.import_module(
    "repro_torch.kernels.swa_attention.swa_attention")


def _text(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_describe_prints_the_references_text_on_its_constants(name):
    assert _text(validate.describe, name, tp=16, hbm_gb=16.0) == \
        _text(jvalidate.describe, name)


def test_the_inspector_speaks_of_h100_nodes():
    assert (validate.TP, validate.HBM_GB, validate.CARDS) == (8, 80.0, 256)
    assert validate.plan_shards() == [("baseline M=32 TP=8", 8),
                                      ("hier M=4 fsdp=8 TP=8", 64)]
    text = _text(validate.main, ["--arch", "dbrx-132b"])
    n = ARCHS["dbrx-132b"].param_count()
    assert "baseline M=32 TP=8" in text and "hier M=4 fsdp=8 TP=8" in text
    assert f"{validate.state_gb(n, 8):5.1f} GB/chip [OVER]" in text
    assert f"{validate.state_gb(n, 64):5.1f} GB/chip [FITS]" in text
    assert validate.state_gb(10 ** 9, 1) == 6.0
    assert (validate.TP, validate.HBM_GB) != (jvalidate.TP,
                                              jvalidate.HBM_GB)


def _real_groups(names, sizes, rank):
    """What ``Mesh._make_group`` would give rank ``rank``: the members of
    each axis group, by brute force over the row-major layout."""
    coords = dict(zip(names, np.unravel_index(rank, sizes)))
    out = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            members = [r for r in range(int(np.prod(sizes)))
                       if all(np.unravel_index(r, sizes)[i] == coords[a]
                              for i, a in enumerate(names) if a not in axes)]
            out[axes] = members
    return out


@pytest.mark.parametrize("nodes, plan, shape", [
    (1, "baseline", (1, 8)), (32, "baseline", (32, 8)),
    (4, "hier", (4, 1, 8)), (32, "hier", (4, 8, 8))])
def test_production_meshes_are_virtual_node_layouts(nodes, plan, shape):
    for rank in (0, 9 % (nodes * 8), nodes * 8 - 1):
        mesh, mplan = mesh_lib.make_production_mesh(nodes, plan=plan,
                                                    rank=rank)
        assert tuple(mesh.shape.values()) == shape
        assert mesh.size == nodes * 8 and mesh.device.type == "meta"
        assert mplan.worker_axes == ("data",)
        assert mplan.model_axes == ("model",)
        for axes, members in _real_groups(mesh.axis_names, shape,
                                          rank).items():
            g = mesh.group(axes)
            assert sorted(g.ranks) == members, axes
            assert g.ranks[g.index] == rank and g.pg is None
            assert g.size == len(members)
    with pytest.raises(ValueError, match="multiple of 4 nodes"):
        mesh_lib.make_production_mesh(2, plan="hier")
    with pytest.raises(ValueError, match="unknown production plan"):
        mesh_lib.make_production_mesh(1, plan="seqshard")


def test_virtual_collectives_return_meta_results():
    from repro_torch.launch import census
    mesh, _ = mesh_lib.make_production_mesh(2, plan="baseline")
    x = torch.empty((3, 5), device="meta")
    with census.counting(census.Census(n_model=8)) as c:
        g = mesh_lib.all_gather(x, mesh.group(("model",)), dim=1)
        r = mesh_lib.ring_gather(x, mesh.group(("data",)), axes=("data",))
        s = mesh_lib.all_reduce(x, mesh.group(("data", "model")))
    assert g.shape == (3, 40) and r.shape == (6, 5) and s is x
    assert g.device.type == r.device.type == "meta"
    res = c.result()
    assert res["collectives"]["all-gather"] == {"bytes": 480.0,
                                                "count": 1.0}
    assert res["collectives"]["collective-permute"] == {"bytes": 60.0,
                                                        "count": 1.0}
    assert res["collectives"]["all-reduce"] == {"bytes": 60.0, "count": 1.0}
    assert res["collective_axis_bytes"] == {"model": 480.0, "data": 60.0,
                                            "mixed": 60.0, "unknown": 0.0}


# ---------------------------------------------------------------------------
# cost(): chip_smoke.py's old inline reckoning, copied
# ---------------------------------------------------------------------------

def _old_pullpush(name, R, n, nblk=0, tree_bytes=0):
    small = 4 * (R * R + 3 * R)
    return {
        "fused_round": (2 * R * n * 4 + small + R * R * 4,
                        2 * (2 * R * R * n)),
        "partial_gram": (R * n * 4 + R * R * 4, 2 * R * R * n),
        "gram_coef": (nblk * R * R * 4 + small + R * R * 4,
                      nblk * R * R + 4 * R ** 3),
        "mix_shard": (2 * R * n * 4 + small, 2 * R * R * n),
        "stale_mix": (3 * R * n * 4 + small, 3 * R * R * n),
        "mix_from_gram": (3 * R * n * 4 + small + R * R * 4, 3 * R * R * n),
        "fused_round_sharded": (3 * R * n * 4, 2 * (2 * R * R * n)),
        "leaf_gram": (tree_bytes + small + R * R * 4, 2 * R * R * n),
        "leaf_mix": (2 * tree_bytes + small, 2 * R * R * n),
    }[name]


PP_SHAPES = ((4, 1_216_385_024), (4, 608_192_512), (8, 4097), (32, 65537))


@pytest.mark.parametrize("R, n", PP_SHAPES)
def test_pullpush_cost_is_the_old_reckoning(R, n):
    base = {"stale_mix": False, "mix_from_gram": True}
    for name in ("fused_round", "partial_gram", "mix_shard", "stale_mix",
                 "mix_from_gram", "fused_round_sharded"):
        got = pk.cost(name, R, n, base=base.get(name, False))
        assert (got["bytes"], got["flops"]) == _old_pullpush(name, R, n)
    got = pk.cost("gram_coef", R, n, nblk=1056)
    assert (got["bytes"], got["flops"]) == _old_pullpush("gram_coef", R, n,
                                                         nblk=1056)
    tree = 9_731_151_360
    for name in ("leaf_gram", "leaf_mix"):
        got = pk.cost(name, R, n, leaf_bytes=tree)
        assert (got["bytes"], got["flops"]) == \
            _old_pullpush(name, R, n, tree_bytes=tree)
    # the strided chunk of phase 13(c): bytes only
    assert pk.cost("partial_gram", R, n // 4)["bytes"] == \
        R * (n // 4) * 4 + R * R * 4
    for x_b, a_b in ((2, 4), (4, 4)):
        assert pk.cost("sq_dist", 1, n, x_bytes=x_b, a_bytes=a_b)["bytes"] \
            == n * (x_b + a_b)
        assert pk.cost("apply_update", 1, n, x_bytes=x_b,
                       a_bytes=a_b)["bytes"] == n * (2 * x_b + a_b)
    with pytest.raises(ValueError, match="unknown kernel"):
        pk.cost("pullpush_fused", R, n)


def _old_in_band(Sq, Skv, causal, window):
    qp = np.arange(Sq)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros_like(qp)
    hi = np.minimum(qp, Skv - 1) if causal else np.full_like(qp, Skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


@pytest.mark.parametrize("case", [
    (4, 8, 4, 8160, 8160, 256, 0, True, 2), (4, 8, 4, 8160, 8160, 256, 4096,
                                              True, 2),
    (4, 28, 4, 8160, 8160, 112, 0, True, 4), (1, 16, 16, 1536, 1536, 64, 0,
                                              False, 2),
    (1, 16, 16, 512, 1536, 64, 0, False, 2), (2, 4, 2, 37, 64, 128, 9, True,
                                              4)])
def test_attention_cost_is_the_old_reckoning(case):
    B, H, Hkv, Sq, Skv, hd, window, causal, esize = case
    got = swa.cost(B, H, Hkv, Sq, Skv, hd, window=window, causal=causal,
                   esize=esize)
    assert got["flops"] == _old_in_band(Sq, Skv, causal, window) \
        * 4 * hd * B * H
    assert got["bytes"] == esize * hd * (2 * B * H * Sq + 2 * B * Hkv * Skv)


@pytest.mark.parametrize("shape", [(4, 8160, 112, 64, 64, 128),
                                   (1, 512, 112, 64, 64, 128),
                                   (2, 70, 3, 16, 8, 32), (1, 33, 2, 16, 8, 8)])
def test_ssd_cost_is_the_old_reckoning(shape):
    Bt, S, H, P, N, L = shape
    nc = -(-S // L)
    pairs = sum(v * (v + 1) // 2 for v in (min(L, S - c * L)
                                            for c in range(nc)))
    got = mk.cost(*shape)
    assert got["bytes"] == 4 * (2 * Bt * S * H * P + Bt * H * nc * P * N
                                + 2 * Bt * S * N + Bt * S * H)
    assert got["flops"] == (Bt * H * (2 * P * pairs + pairs + 2 * P * N * S)
                            + Bt * 2 * N * pairs)


@pytest.mark.parametrize("shape", [(4, 4096, 4, 512), (1, 512, 4, 512),
                                   (4, 1, 4, 512), (3, 7, 2, 8)])
def test_slstm_cost_is_the_old_reckoning(shape):
    B, T, H, P = shape
    got = sk.cost(*shape)
    assert got["flops"] == 2 * B * T * H * P * 4 * P
    assert got["bytes"] == 4 * (B * T * H * 4 * P + H * P * 4 * P
                                + B * T * H * P + 8 * B * H * P)
