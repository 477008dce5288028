"""The port's split of a served model over a ``model`` group against the
reference's sharding rules (``repro/launch/mesh.py``: ``_leaf_spec`` over
``_RULES`` / ``_MOE_RULES``, ``serve_shardings``), on the full-size
parameter and decode-state trees of every dense and MoE config at
``model`` 2, 4 and 8 (shapes only, on ``meta``), and the dry-run's
serving plan over an H100 node's ``model`` axis.

Where the reference's split cannot run as an explicit one the port
places the leaf as its forward needs it. Those leaves are listed here by
config, group size and path (``PLACED_APART``), so that the difference is
written down: KV projections and caches whose heads are fewer than the
ranks (the reference cuts inside a head, the port gives each head to the
ranks whose query heads read it) and llama4-scout's shared expert (the
reference's expert rule lands on its layer dim; the port splits it as
the tensor-parallel MLP it is)."""
from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MeshPlan as JMeshPlan
from repro.launch import mesh as jmesh
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, reduced
from repro_torch.configs.base import MeshPlan
from repro_torch.core.engine import tree_items
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mm
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as lm
from repro_torch.models.parallel import TP, local_config
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)

SPLIT = [a for a, c in ARCHS.items() if c.family in ("dense", "moe")]
SIZES = (2, 4, 8)
_SHARED = ["blocks/stack/moe/shared/w_down", "blocks/stack/moe/shared/w_gate",
           "blocks/stack/moe/shared/w_up"]
_KV = ["blocks/stack/attn/wk", "blocks/stack/attn/wv", "k", "v"]
# (arch, model size) -> the leaves the port places apart from the reference
PLACED_APART = {("llama4-scout-17b-a16e", m): _SHARED for m in SIZES}
PLACED_APART.update({("yi-6b", 8): _KV, ("gemma2-2b", 8): _KV})


def _ref_model_dim(path, shape, m):
    spec = jmesh._leaf_spec(types.SimpleNamespace(shape={"data": 1,
                                                         "model": m}),
                            path, shape, JMeshPlan(), stacked=False)
    return next((d for d, e in enumerate(spec) if e == "model"), None)


def _ref_serve_dims(states, m, monkeypatch):
    """{path: dim} of the reference's ``serve_shardings`` model placement
    for a tree of ``ShapeDtypeStruct``s (its NamedShardings read as
    their specs)."""
    monkeypatch.setattr(jmesh, "NamedSharding", lambda mesh, spec: spec)
    sds = {k: jax.ShapeDtypeStruct(tuple(v.shape), str(v.dtype)
                                   .removeprefix("torch."))
           for k, v in states.items()}
    specs = jmesh.serve_shardings(types.SimpleNamespace(
        shape={"data": 1, "model": m}), sds, JMeshPlan(), batch=1,
        data_ok=False)
    return {k: next((d for d, e in enumerate(s) if e == "model"), None)
            for k, s in specs.items()}


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("arch", SPLIT)
def test_split_dims_match_the_reference_rules(arch, m, monkeypatch):
    cfg = get_arch(arch)
    params = lm.init_lm(cfg, None, device="meta")
    apart = []
    for path, leaf in tree_items(params):
        shape = tuple(leaf.shape)
        ref = _ref_model_dim(list(path), shape, m)
        assert mm.model_dim(path, shape, m) == ref, path
        got = mm.tp_split(cfg, path, shape, m)
        if got != (None if ref is None else mm.Split(ref, m)):
            apart.append("/".join(path))
    states = lm.init_states(cfg, 1, 1, torch.float32, device="meta")
    ref_dims = _ref_serve_dims(states, m, monkeypatch)
    for name, leaf in states.items():
        ref = ref_dims[name]
        shape = tuple(leaf.shape)
        assert mm.serve_model_dim((name,), shape, m,
                                  integer=not leaf.is_floating_point()) \
            == ref, name
        if mm.state_split(cfg, (name,), shape, m) != (
                None if ref is None else mm.Split(ref, m)):
            apart.append(name)
    assert sorted(apart) == sorted(PLACED_APART.get((arch, m), [])), apart
    assert sorted(mm.placed_apart(cfg, m)) == sorted(apart)


@pytest.mark.parametrize("arch", SPLIT)
def test_a_rank_holds_its_shard(arch):
    """Every rank's shard has the local config's shapes: the shard of a
    full meta tree (``build_model(cfg, mesh).init``) equals the leaves cut
    by ``tp_split``, the KV cache holds max(nkv / 8, 1) heads, and a
    replicated KV head is the one its rank's query heads read."""
    cfg = get_arch(arch)
    full = dict(tree_items(lm.init_lm(cfg, None, device="meta")))
    for r in (0, 5):
        mesh = mm.VirtualMesh(mm.FLAT_AXES, (1, 8), rank=r)
        model = build_model(cfg, mesh, MeshPlan())
        shard = model.init(None, "meta")
        local = model.tp.cfg
        assert local.head_dim == cfg.head_dim and \
            local.n_heads == cfg.n_heads // 8
        for path, leaf in tree_items(shard):
            split = mm.tp_split(cfg, path, full[path].shape, 8)
            want = list(full[path].shape)
            if split is not None:
                want[split.dim] //= split.parts
            assert list(leaf.shape) == want, path
        states, _ = model.make_state(shard, {"tokens": torch.zeros(
            (2, 1), dtype=torch.int64)}, 16)
        assert states["k"].shape[-2:] == (max(cfg.n_kv_heads // 8, 1),
                                          cfg.head_dim)
        g = cfg.n_heads // cfg.n_kv_heads
        kv = mm.tp_split(cfg, ("blocks", "stack", "attn", "wk"),
                         full[("blocks", "stack", "attn", "wk")].shape, 8)
        assert kv.piece(r, 8) == (r * local.n_heads) // g


def test_numpy_shards_equal_tensor_shards():
    """``shard_params`` of the reference's numpy tree (through
    ``params_from_numpy``) equals the shard of the same tree as tensors,
    on every rank of a 4-rank group, replicated KV heads included."""
    cfg = reduced(get_arch("gemma2-2b"))
    rng = np.random.default_rng(0)
    np_tree = {}
    for path, leaf in tree_items(lm.init_lm(cfg, None, device="meta")):
        d = np_tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = rng.standard_normal(tuple(leaf.shape)).astype(
            np.float32)
    full = params_from_numpy(cfg, np_tree, device="cpu")
    for r in range(4):
        mesh = mm.VirtualMesh(mm.FLAT_AXES, (1, 4), rank=r, device="cpu")
        a = dict(tree_items(mm.shard_params(cfg, np_tree, mesh, MeshPlan())))
        b = dict(tree_items(mm.shard_params(cfg, full, mesh, MeshPlan())))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    wk = b[("blocks", "stack", "attn", "wk")]
    # rank 3 of 4 reads KV head 1 of 2 (query heads 3 of 4, 2 a KV head)
    assert torch.equal(wk, full["blocks"]["stack"]["attn"]["wk"][..., 64:])


def test_what_a_model_group_does_not_split():
    for arch in ("zamba2-7b", "xlstm-350m", "seamless-m4t-medium",
                 "internvl2-2b"):
        with pytest.raises(ValueError, match="tensor-parallel serving"):
            build_model(get_arch(arch), mm.VirtualMesh(mm.FLAT_AXES, (1, 2)),
                        MeshPlan())
    with pytest.raises(ValueError, match="40 query heads"):
        build_model(get_arch("llama4-scout-17b-a16e"),
                    mm.VirtualMesh(mm.FLAT_AXES, (1, 16)), MeshPlan())
    # a group of one, or none, is the one-device model
    cfg = get_arch("yi-6b")
    assert TP.of(cfg, None, None) is None
    assert build_model(cfg, mm.VirtualMesh(mm.FLAT_AXES, (8, 1)),
                       MeshPlan()).tp is None
    assert local_config(cfg, 4).head_dim == 128


@pytest.mark.parametrize("nodes, fits", [(32, True), (1, False)])
def test_dry_run_serves_dbrx_over_the_model_axis(nodes, fits, tmp_path):
    """dbrx-132b ``decode_32k``: one replica over a node's 8 cards. At 32
    nodes (4 sequences a replica) its ~32.9 GB of weights and ~2.7 GB of
    cache a card fit; at 1 node (all 128 sequences) the cache does not."""
    rec = dryrun.run_one("dbrx-132b", "decode_32k", nodes,
                         out_dir=str(tmp_path))
    cfg = get_arch("dbrx-132b")
    assert rec["engine"] == "one replica over model = 8"
    assert rec["fits"] is fits and rec["placed_apart"] == {}
    assert rec["replicas"] == nodes and rec["batch_per_replica"] == \
        INPUT_SHAPES["decode_32k"].global_batch // nodes
    weights = rec["param_bytes_per_card"]
    assert abs(weights - cfg.param_count() * 2 / 8) < 0.01 * weights
    cache = rec["memory"]["argument_size_in_bytes"] - weights
    want = 40 * 2 * 32768 * 1 * 128 * 2 * rec["batch_per_replica"]
    assert abs(cache - want) < 0.01 * want
    assert rec["collective_axis_bytes"]["model"] > 0
    assert rec["collective_axis_bytes"]["data"] == 0
    # a layer's attention output and expert combine; the embedding, each
    # layer's router logits and the head's
    assert rec["collectives"]["all-reduce"]["count"] == 2 * cfg.n_layers
    assert rec["collectives"]["all-gather"]["count"] == cfg.n_layers + 2
