"""The port's meshes of ranks (``repro_torch.launch.mesh``) against the
reference's ``repro/launch/mesh.py``: the column rule and the flat view's
row and column rule on stub meshes (pure functions of the mesh shape),
the builders' errors, the ``_lin_index`` rank order, the collectives on
four gloo ranks, and ``fused_round_sharded``'s plain version on 2 and 4
column shards against the reference's ``fused_round`` (interpret mode) on
the whole view."""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
import repro.launch.mesh as jmesh
from repro.configs import MeshPlan as JMeshPlan
from repro.kernels.pullpush import pullpush as jpk
from repro_torch.configs.base import MeshPlan
from repro_torch.kernels.pullpush import pullpush as pk
from repro_torch.kernels.pullpush import ref
from repro_torch.launch import mesh as mm

PLANS = {
    "hier": (MeshPlan(worker_axes=("data",), fsdp_axes=("fsdp",),
                      model_axes=("model",)),
             JMeshPlan(worker_axes=("data",), fsdp_axes=("fsdp",),
                       model_axes=("model",))),
    "flat": (MeshPlan(worker_axes=("data",), model_axes=("model",)),
             JMeshPlan(worker_axes=("data",), model_axes=("model",))),
}
SHAPES = [("hier", {"data": 2, "fsdp": 2, "model": 3}),
          ("hier", {"data": 2, "fsdp": 2, "model": 2}),
          ("hier", {"data": 1, "fsdp": 4, "model": 1}),
          ("flat", {"data": 4, "model": 2}),
          ("flat", {"data": 8, "model": 1}),
          ("flat", {"data": 1, "model": 3})]
NS = (1, 7, 8, 9, 12, 24, 244, 5772289)


@pytest.mark.parametrize("kind, shape", SHAPES)
def test_flat_col_rule_matches_reference(kind, shape):
    mesh = SimpleNamespace(shape=shape)
    plan, jplan = PLANS[kind]
    for n in NS:
        assert mm.flat_col_axes(mesh, n, plan) == \
            jmesh.flat_col_axes(mesh, n, jplan), n
        assert mm.flat_col_entry(mesh, n, plan) == \
            jmesh.flat_col_entry(mesh, n, jplan), n


@pytest.mark.parametrize("kind, shape", SHAPES)
def test_flat_view_spec_matches_reference(kind, shape, monkeypatch):
    """The row and column rule of ``flat_view_sharding`` (its
    ``NamedSharding`` replaced by its spec, so a stub mesh suffices)."""
    monkeypatch.setattr(jmesh, "NamedSharding", lambda mesh, spec: spec)
    mesh = SimpleNamespace(shape=shape)
    plan, jplan = PLANS[kind]
    for R in (1, 4, 5, 8, 9):
        for n in NS:
            for shp in ((R, n), (3, R, n)):
                assert mm.flat_view_spec(mesh, shp, plan) == \
                    tuple(jmesh.flat_view_sharding(mesh, shp, jplan)), shp


@pytest.mark.parametrize("sizes", [(4, 2), (2, 2, 2), (2, 3, 2), (1, 4, 3)])
def test_lin_index_is_the_reference_rank_order(sizes, monkeypatch):
    """``lin_index`` over every axis group equals the reference's
    ``train/trainer.py::_lin_index`` (``jax.lax.axis_index`` patched to
    the coordinates), and over all axes it is the row-major rank."""
    from itertools import combinations, product

    from repro.train import trainer as jtrainer
    names = mm.HIER_AXES if len(sizes) == 3 else mm.FLAT_AXES
    shape = dict(zip(names, sizes))
    for coords in product(*(range(s) for s in sizes)):
        c = dict(zip(names, coords))
        monkeypatch.setattr(jax.lax, "axis_index", lambda a: c[a])
        assert mm.lin_index(names, shape, c) == \
            int(np.ravel_multi_index(coords, sizes))
        for k in range(1, len(names) + 1):
            for axes in combinations(names, k):
                assert mm.lin_index(axes, shape, c) == \
                    int(jtrainer._lin_index(axes, shape)), (axes, c)


def test_builders_refuse_bad_shapes_in_a_world_of_one():
    with pytest.raises(ValueError, match=">= 1"):
        mm.make_hierarchical_mesh(0, 2, 2)
    with pytest.raises(ValueError, match=">= 1"):
        mm.make_hier_engine_mesh(2, 0, 1)
    with pytest.raises(ValueError, match="world has 1"):
        mm.make_hier_engine_mesh(2, 2, 2)
    with pytest.raises(ValueError, match="exactly the world"):
        mm.make_hierarchical_mesh(1, 2, 1)
    with pytest.raises(ValueError, match="world has 1"):
        mm.Mesh(mm.FLAT_AXES, (2, 1))
    with pytest.raises(ValueError, match=">= 1"):
        mm.make_flat_engine_mesh(0)
    mesh, plan = mm.make_flat_engine_mesh(4, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert plan.worker_axes == ("data",) and plan.model_axes == ("model",)
    hmesh, hplan = mm.make_hier_engine_mesh(1, 1, 1, device="cpu")
    assert hmesh.shape == {"data": 1, "fsdp": 1, "model": 1}
    assert hplan == mm.hierarchical_plan()
    cpu = mm.make_cpu_mesh()
    assert cpu.shape == {"data": 1, "model": 1} and cpu.rank == 0
    x = torch.arange(6.0).reshape(2, 3)
    assert mm.all_gather(x, cpu.group(("data",))) is x
    assert mm.all_reduce(x, cpu.group(("data", "model"))) is x
    with pytest.raises(ValueError, match="mesh order"):
        cpu.group(("model", "data"))


def test_backend_is_chosen_by_the_cards():
    assert mm.choose_backend("cuda", 2, 2) == "nccl"
    assert mm.choose_backend("cuda", 4, 8) == "nccl"
    assert mm.choose_backend("cuda", 2, 1) == "gloo"     # ranks share a card
    assert mm.choose_backend("cpu", 1, 8) == "gloo"


def _members(sizes, names, axes):
    """Rank 0's group over ``axes``: the ranks whose other coordinates are
    0, in rank order."""
    from itertools import product
    shape = dict(zip(names, sizes))
    out = []
    for coords in product(*(range(s) for s in sizes)):
        c = dict(zip(names, coords))
        if all(c[a] == 0 for a in names if a not in axes):
            out.append(mm.lin_index(names, shape, c))
    return out


def test_collectives_on_four_gloo_ranks():
    """Concatenation order of the gathers (row-major over the group, as
    the reference's tiled ``all_gather``), the all-reduce, every group of
    five meshes of one world, a gather in column pieces (the staged
    path's) equal to the whole, and ``fused_round_sharded`` over 1, 2 and 4
    column shards within 1e-6 of each row's scale of ``fused_round`` on
    the whole view (r within 1e-6 relative)."""
    seen = td.spawn(td.mesh_checks, 4)[0]
    assert seen["transport"]["backend"] == "gloo"
    assert seen["transport"]["world"] == 4
    for names, sizes in ((mm.FLAT_AXES, (2, 2)), (mm.FLAT_AXES, (1, 4)),
                         (mm.FLAT_AXES, (4, 1)), (mm.HIER_AXES, (2, 1, 2)),
                         (mm.HIER_AXES, (1, 2, 2))):
        got = seen["x".join(map(str, sizes))]
        assert got["coords"] == {a: 0 for a in names}
        for axes in ((names[0],), tuple(names[1:]), (names[-1],)):
            rows, cols, tot, size = got[axes]
            members = _members(sizes, names, axes)
            assert size == len(members)
            assert rows == [float(m) for m in members for _ in range(2)]
            assert cols == [float(m) for m in members for _ in range(3)]
            assert tot == [float(sum(members)), float(len(members))]
    assert all(v for k, v in seen.items() if k.startswith("pieces"))
    assert len([k for k in seen if k.startswith("pieces")]) == 3
    for cols in (1, 2, 4):
        err, r_err = seen[f"sharded{cols}"]
        assert err <= 1e-6 and r_err <= 1e-6, (cols, err, r_err)


@pytest.mark.parametrize("shards", [2, 4])
def test_fused_round_sharded_plain_matches_reference(shards):
    """Each shard's stage with the shards' partial Grams summed (the
    all-reduce, in process) against the reference's ``fused_round`` in
    interpret mode on the whole view: out within 1e-6 of each row's
    scale, r within 1e-6 relative, every shard the same r."""
    rng = np.random.default_rng(3)
    R, n = 5, 3001 * shards
    x = (rng.standard_normal((R, n)) * 2.0 + 1.0).astype(np.float32)
    T = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((R, R)).astype(np.float32)), axis=1))
    c0 = np.linspace(0.1, 0.5, R).astype(np.float32)
    c1 = np.linspace(-0.4, -0.1, R).astype(np.float32)
    jout, jr, _ = jpk.fused_round(jnp.asarray(x), jnp.asarray(T),
                                  jnp.asarray(c0), jnp.asarray(c1),
                                  block_cols=1024, interpret=True)
    jout, jr = np.asarray(jout), np.asarray(jr)
    pieces = np.split(x, shards, axis=1)
    partials = [ref.partial_gram_plain(torch.tensor(p)) for p in pieces]
    tT, tc0, tc1 = map(torch.tensor, (T, c0, c1))
    n_loc = n // shards
    for j, piece in enumerate(pieces):
        others = sum(partials[k] for k in range(shards) if k != j)
        out, r, _ = ref.fused_round_sharded_plain(
            torch.tensor(piece), tT, tc0, tc1, lambda G: G.add_(others))
        want = jout[:, j * n_loc:(j + 1) * n_loc]
        scale = np.abs(want).max(axis=1)
        err = (np.abs(out.numpy() - want).max(axis=1) / scale).max()
        assert err <= 1e-6, (j, err)
        assert np.abs(r.numpy() - jr).max() <= 1e-6 * np.abs(jr).max(), j


def test_fused_round_sharded_wrapper_on_cpu_runs_its_plain_version():
    """A group of one: the wrapper's stage is ``fused_round``'s, and it
    checks its inputs as the other wrappers do; the stale epilogue with
    ``base`` too."""
    one = mm.make_cpu_mesh().group(("model",))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 777), generator=gen)
    q = torch.randn((4, 777), generator=gen)
    T = torch.softmax(torch.randn((4, 4), generator=gen), dim=1)
    c0, c1 = torch.full((4,), 0.2), torch.full((4,), -0.1)
    out, r, G = pk.fused_round_sharded(x, T, c0, c1, group=one)
    w_out, w_r, w_G = ref.fused_round_plain(x, T, c0, c1)
    assert torch.equal(out, w_out) and torch.equal(r, w_r) \
        and torch.equal(G, w_G)
    out, _, _ = pk.fused_round_sharded(x, T, c0, c1, group=one, base=q)
    w_out, _, _ = ref.mix_from_gram_plain(x, T, c0, c1, w_G, base=q)
    assert torch.equal(out, w_out)
    with pytest.raises(ValueError):
        pk.fused_round_sharded(x[:, None], T, c0, c1, group=one)
    with pytest.raises(ValueError):
        pk.fused_round_sharded(x, T, c0, c1, group=one, base=q[:, :9])
    assert pk.LAUNCHES["fused_round_sharded"] == 0    # no launch on CPU
