"""The port's encoder-decoder backbone (``repro_torch/models/encdec.py``,
reduced seamless-m4t-medium: 2 + 2 layers, 8 frames) against the JAX
package on the same numpy inputs, on the CPU: ``encode``,
``decode_stack``, the loss and its gradients, the serving lanes
(``make_state``, one-shot and chunked prefill, decode steps) against the
reference's states and logits, the numpy carriers, decode against teacher
forcing, and the full-size tree (with the reference's ``param_count()``
fault)."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models import transformer as jlm
from repro_torch.configs import get_arch, reduced
from repro_torch.core.engine import tree_from_items, tree_items
from repro_torch.models import (
    build_model, params_from_numpy, states_from_numpy,
)
from repro_torch.models import encdec
from repro_torch.models import transformer as lm
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)
from _torch_serving import _same_states

NAME = "seamless-m4t-medium"
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _mp():
    """(reference model, reference params, cfg, model, params)."""
    jcfg, cfg = jreduced(jget_arch(NAME)), reduced(get_arch(NAME))
    jmodel = jbuild_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, cfg, build_model(cfg), params


def _inputs(B=2, S=12, seed=0, F=None):
    cfg = _mp()[2]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    enc = (0.5 * rng.normal(size=(B, F or cfg.n_prefix, cfg.d_model))
           ).astype(np.float32)
    return tokens, labels, enc


def _batches(tokens, labels, enc):
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "enc": jnp.asarray(enc)}
    b = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
         "labels": torch.from_numpy(labels.astype(np.int64)),
         "enc": torch.from_numpy(enc)}
    return jb, b


def test_encode_and_decode_stack_match_reference():
    jmodel, jparams, cfg, model, params = _mp()
    jcfg = jmodel.cfg
    tokens, _, enc = _inputs()
    jout = jencdec.encode(jcfg, jparams, jnp.asarray(enc))
    with torch.no_grad():
        out = encdec.encode(cfg, params, torch.from_numpy(enc))
        # the serving route (the kernel's plain version on the CPU)
        kout = encdec.encode(cfg, params, torch.from_numpy(enc),
                             kernel=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(kout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    jx = jlm._embed(jparams, jcfg, jnp.asarray(tokens))
    jx, _ = jencdec.decode_stack(jcfg, jparams, jx, enc_out=jout)
    with torch.no_grad():
        x = lm._embed(params, cfg, torch.from_numpy(tokens.astype(np.int64)))
        x, _ = encdec.decode_stack(cfg, params, x, enc_out=out)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=ATOL)


def test_loss_and_gradients_match_reference():
    jmodel, jparams, cfg, model, params = _mp()
    jb, b = _batches(*_inputs(seed=1))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, jb)
    items = [(p, l.detach().clone().requires_grad_(True))
             for p, l in tree_items(params)]
    loss, metrics = model.loss(tree_from_items(items), b)
    grads = torch.autograd.grad(loss, [l for _, l in items])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0,
                               atol=ATOL)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    assert set(metrics) == {"loss", "aux"}
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=ATOL)


@pytest.mark.parametrize("mode", ["full", "ring"])
def test_serving_lanes_match_reference(mode):
    """make_state (the encoder pass and the cross k / v, once), one-shot
    prefill (full mode), chunk-by-chunk prefill and decode steps: logits
    within 1e-4, the states leaf by leaf ({"self", "ck", "cv"})."""
    jmodel, jparams, cfg, model, params = _mp()
    buf, window, chunk, S = {"full": (32, 0, 8, 20),
                             "ring": (19, 16, 4, 24)}[mode]
    tokens, _, enc = _inputs(S=S, seed=2)
    follow = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 4))
    jb = {"tokens": jnp.asarray(tokens), "enc": jnp.asarray(enc)}
    b = {"tokens": tokens, "enc": enc}
    if S <= buf:
        jl, js = jmodel.prefill(jparams, jb, buf_len=buf, window=window)
        lg, st = model.prefill(params, b, buf, window=window)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        _same_states(st, js)
    js, jstart = jmodel.make_state(jparams, jb, buf, window=window)
    st, start = model.make_state(params, b, buf, window=window)
    assert start == int(jstart) == 0
    assert sorted(st) == ["ck", "cv", "self"]
    assert st["ck"].shape == (cfg.n_layers, 2, cfg.n_prefix, cfg.n_kv_heads,
                              cfg.head_dim)
    _same_states(st, js)
    jchunk = jax.jit(lambda p, s, t, i: jmodel.prefill_chunk(
        p, s, t, i, window=window))
    for j in range(0, S, chunk):
        jl, js = jchunk(jparams, js, jnp.asarray(tokens[:, j:j + chunk]),
                        jnp.int32(j))
        lg, st = model.prefill_chunk(params, st, tokens[:, j:j + chunk], j,
                                     window=window)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"chunk at {j}")
    _same_states(st, js)
    jstep = jax.jit(lambda p, s, t, i: jmodel.decode_step(
        p, s, t, i, window=window))
    for i in range(follow.shape[1]):
        jl, js = jstep(jparams, js, jnp.asarray(follow[:, i:i + 1]),
                       jnp.int32(S + i))
        lg, st = model.decode_step(params, st, follow[:, i:i + 1], S + i,
                                   window=window)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"decode {i}")
    _same_states(st, js)


def test_decode_matches_teacher_forcing():
    """The reference's own test on the port: prefill S - 1 tokens, one
    decode step, against the teacher-forced logits of the last position
    (here within 1e-4: fp32 throughout)."""
    _, _, cfg, model, params = _mp()
    tokens, _, enc = _inputs(S=16, seed=4)
    with torch.no_grad():
        enc_out = encdec.encode(cfg, params, torch.from_numpy(enc))
        x = lm._embed(params, cfg, torch.from_numpy(tokens.astype(np.int64)))
        x, _ = encdec.decode_stack(cfg, params, x, enc_out=enc_out)
        full = lm._head(params, cfg, x)
    _, st = model.prefill(params, {"tokens": tokens[:, :-1], "enc": enc},
                          buf_len=20)
    lg, _ = model.decode_step(params, st, tokens[:, -1:], 15)
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), rtol=0,
                               atol=ATOL)


def test_numpy_carriers_take_the_encdec_trees():
    """``params_from_numpy`` checks and copies the enc-dec tree;
    ``states_from_numpy`` reads batch and buffer from the ``self`` cache
    and the frames from ``ck``, and the carried states decode as the
    reference's."""
    jmodel, jparams, cfg, model, params = _mp()
    np_params = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(cfg, {k: v for k, v in np_params.items()
                                if k != "enc_norm"}, device="cpu")
    bf = params_from_numpy(cfg, np_params, device="cpu",
                           dtype=torch.bfloat16)
    assert bf["dec"]["xattn"]["wq"].dtype == torch.bfloat16
    tokens, _, enc = _inputs(S=6, seed=5, F=5)
    jl, js = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                      "enc": jnp.asarray(enc)}, buf_len=16)
    st = states_from_numpy(cfg, jax.tree.map(np.asarray, js), device="cpu")
    assert st["self"]["k"].shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                                     cfg.head_dim)
    assert st["ck"].shape[2] == 5 and st["self"]["pos"].dtype == torch.int32
    jl2, _ = jmodel.decode_step(jparams, js, jnp.asarray([[3], [4]]), 6)
    lg2, _ = model.decode_step(params, st, np.asarray([[3], [4]]), 6)
    np.testing.assert_allclose(lg2.numpy(), np.asarray(jl2), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="shape"):
        states_from_numpy(cfg, dict(jax.tree.map(np.asarray, js),
                                    cv=np.zeros((2, 2, 4, 4, 64),
                                                np.float32)), device="cpu")


# seamless-m4t-medium's tree, counted from the reference's init
SEAMLESS_PARAMS = 977_758_208
SEAMLESS_PARAM_COUNT = 977_757_184      # what ModelConfig.param_count() says


def test_full_tree_and_reference_param_count_omits_encoder_norm():
    """The full-size tree (meta device) has the reference's paths, shapes
    and dtypes and 977,758,208 parameters. A fault of the reference
    (ROADMAP.md Queue 3): ``param_count()`` leaves out the encoder's final
    norm (d_model = 1024), 977,757,184; the port's config copy keeps the
    reference's number."""
    jcfg, cfg = jget_arch(NAME), get_arch(NAME)
    want = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(tree_items(build_model(cfg).init(None, "meta")))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == \
            want[path].dtype.name, path
    n = sum(leaf.numel() for leaf in got.values())
    assert n == SEAMLESS_PARAMS
    assert cfg.param_count() == jcfg.param_count() == SEAMLESS_PARAM_COUNT
    assert SEAMLESS_PARAMS - SEAMLESS_PARAM_COUNT == cfg.d_model
    assert got[("dec", "xattn", "wk")].shape == (12, 1024, 1024)
    assert got[("enc", "mlp", "w_up")].shape == (12, 1024, 4096)
