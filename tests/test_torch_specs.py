"""The dry-run's inputs and its flop count against the reference.

``repro_torch.launch.specs`` builds ``meta`` tensors where the reference's
``repro/launch/specs.py`` builds ``jax.ShapeDtypeStruct``s: the train,
ddp, prefill and decode inputs, the parameter tree and the decode states
hold the same tree paths (``params_from_numpy`` / ``states_from_numpy``
name both trees the reference's way), shapes and dtypes, under the one
stated mapping ``specs.DTYPE_MAP`` (token and label ids and the decode
index int32 -> int64; the cache's ``pos`` stays int32), for every
reduced arch at every input shape and for full-size yi-6b and zamba2-7b.

``launch.roofline.analyze_step``'s ``flops`` (matmul ops, 2 M N K, traced
on ``meta``) for one local step, loss and gradient, of reduced yi-6b (with
``remat`` on and off) and of the harness MLP lie within 1% of the
reference's ``analyze_hlo`` on its compiled CPU step.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import benchmarks.common as jcommon
from repro.configs import ARCHS as JARCHS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import reduced as jreduced
from repro.launch import specs as jspecs
from repro.launch.roofline import analyze_hlo
from repro.models import build_model as jbuild
from repro_torch.benchmarks import common as pcommon
from repro_torch.configs import ARCHS, INPUT_SHAPES, MeshPlan, reduced
from repro_torch.core.engine import tree_from_items, tree_items
from repro_torch.launch import specs
from repro_torch.launch.roofline import analyze_step
from repro_torch.models import build_model
from repro_torch.optim import value_and_grad

from _torch_dist import _one_torch_thread  # noqa: F401  (autouse)

FLOP_RTOL = 0.01
FULL = ("yi-6b", "zamba2-7b")
PLAN = MeshPlan(worker_axes=("data",), model_axes=("model",))
M, TAU = 4, 4


def _ref_items(tree, ids=False):
    """(path, shape, dtype name) of a reference spec tree; ``ids``: a tree
    of token ids, whose dtype goes through ``specs.DTYPE_MAP``."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        dtype = str(leaf.dtype)
        if ids:
            dtype = specs.DTYPE_MAP.get(dtype, dtype)
        out.append((keys, tuple(leaf.shape), dtype))
    return sorted(out)


def _port_items(tree):
    out = []
    for path, leaf in tree_items(tree):
        assert leaf.device.type == "meta", path
        out.append((tuple(path), tuple(leaf.shape),
                    str(leaf.dtype).removeprefix("torch.")))
    return sorted(out)


def _configs(name, full):
    if full:
        return JARCHS[name], ARCHS[name]
    return jreduced(JARCHS[name]), reduced(ARCHS[name])


CASES = [(n, False) for n in sorted(ARCHS)] + [(n, True) for n in FULL]


@pytest.mark.parametrize("name, full", CASES,
                         ids=[f"{n}-{'full' if f else 'reduced'}"
                              for n, f in CASES])
def test_specs_equal_the_references(name, full):
    jcfg, cfg = _configs(name, full)
    assert _port_items(specs.param_specs(cfg)) == \
        _ref_items(jspecs.param_specs(jcfg))
    for sname, shape in INPUT_SHAPES.items():
        jshape = JSHAPES[sname]
        assert specs.serve_window_for(cfg, shape) == \
            jspecs.serve_window_for(jcfg, jshape)
        assert specs.buf_len_for(cfg, shape) == \
            jspecs.buf_len_for(jcfg, jshape)
        modes = ("train", "ddp", "prefill", "decode") \
            if shape.kind == "train" else (shape.kind,)
        for mode in modes:
            got = specs.input_specs(cfg, shape, PLAN, mode, M, TAU)
            want = jspecs.input_specs(jcfg, jshape, None, mode, M, TAU)
            if mode == "decode":
                (tok, idx, st), (jtok, jidx, jst) = got, want
                assert _port_items(st) == _ref_items(jst), (sname, mode)
                got, want = {"token": tok, "index": idx}, \
                    {"token": jtok, "index": jidx}
            assert _port_items(got) == _ref_items(want, ids=True), \
                (sname, mode)


def test_dtype_mapping_is_the_token_ids_only():
    cfg = reduced(ARCHS["yi-6b"])
    batch = specs.train_batch_specs(cfg, INPUT_SHAPES["train_4k"], M, TAU)
    assert {t.dtype for t in batch.values()} == {torch.int64}
    assert jspecs.TOK == jnp.int32 and specs.TOK == torch.int64
    assert specs.DTYPE_MAP == {"int32": "int64"}
    states = specs.decode_state_specs(cfg, INPUT_SHAPES["decode_32k"])
    assert {str(l.dtype) for p, l in tree_items(states)
            if p[-1] == "pos"} == {"torch.int32"}
    with pytest.raises(ValueError, match="not divisible"):
        specs.train_batch_specs(cfg, INPUT_SHAPES["train_4k"], 3, TAU)


def _ref_step_flops(loss, params, batch):
    step = jax.jit(jax.value_and_grad(lambda p, b: loss(p, b)[0]))
    return analyze_hlo(step.lower(params, batch).compile().as_text())["flops"]


def _port_step_flops(loss, params, batch):
    params = tree_from_items([(p, l.requires_grad_())
                              for p, l in tree_items(params)])
    return analyze_step(lambda p, b: value_and_grad(loss, p, b), params,
                        batch)["flops"]


@pytest.mark.parametrize("remat", [False, True])
def test_step_flops_match_the_references_hlo_lm(remat):
    B, S = 2, 64
    jcfg = dataclasses.replace(jreduced(JARCHS["yi-6b"]), remat=remat)
    cfg = dataclasses.replace(reduced(ARCHS["yi-6b"]), remat=remat)
    jm, m = jbuild(jcfg), build_model(cfg)
    want = _ref_step_flops(
        jm.loss, jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
        {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
         for k in ("tokens", "labels")})
    got = _port_step_flops(
        m.loss, specs.param_specs(cfg),
        {k: torch.empty((B, S), dtype=torch.int64, device="meta")
         for k in ("tokens", "labels")})
    assert want > 0
    assert got == pytest.approx(want, rel=FLOP_RTOL)


def test_step_flops_match_the_references_hlo_mlp():
    dim, ncls, width, bs = 32, 10, 64, 64
    want = _ref_step_flops(
        jcommon.mlp_loss,
        jax.eval_shape(lambda k: jcommon.mlp_init(k, dim, ncls, width),
                       jax.random.PRNGKey(0)),
        {"x": jax.ShapeDtypeStruct((bs, dim), jnp.float32),
         "y": jax.ShapeDtypeStruct((bs,), jnp.int32)})
    got = _port_step_flops(
        pcommon.mlp_loss,
        pcommon.mlp_init(None, dim, ncls, width, device="meta"),
        {"x": torch.empty((bs, dim), device="meta"),
         "y": torch.empty((bs,), dtype=torch.int64, device="meta")})
    assert want > 0
    assert got == pytest.approx(want, rel=FLOP_RTOL)
