"""The port's transformer against the JAX package: the reference's
initial weights carried across as numpy, the same tokens, logits / loss /
gradients compared in fp32 on the CPU, for the dense families, the
hybrid one (zamba2-7b at 6 layers, one full cycle, and at 9, with the
remainder blocks of the full config) and the recurrent one (xlstm-350m at
4 layers, one cycle, and at 8, two cycles, on the per-step mLSTM of its
published config; and with ``xlstm_chunk = 16``, the chunked mLSTM). The
full-size zamba2-7b and xlstm-350m trees are held against the
reference's shapes on the ``meta`` device."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.core.engine import ConsensusEngine as JEngine
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import transformer as jlm
from repro_torch.configs import get_arch, reduced
from repro_torch.core.engine import (
    ConsensusEngine, tree_from_items, tree_items,
)
from repro_torch.models import attention as attn
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as lm
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)


# "name@L": the reduced config cut to L layers; "/chunkN": xlstm_chunk N
ARCHS = ("yi-6b", "gemma2-2b", "zamba2-7b", "zamba2-7b@9", "xlstm-350m",
         "xlstm-350m@8", "xlstm-350m/chunk16")
ATOL = 1e-4


def _overrides(arch):
    """'name[@L][/chunkN]' -> (name, reduced() overrides)."""
    arch, _, chunk = arch.partition("/chunk")
    name, _, layers = arch.partition("@")
    kw = {"n_layers": int(layers)} if layers else {}
    if chunk:
        kw["xlstm_chunk"] = int(chunk)
    return name, kw


def _configs(arch):
    """(reference cfg, port cfg) of a reduced arch."""
    name, kw = _overrides(arch)
    return jreduced(jget_arch(name), **kw), reduced(get_arch(name), **kw)


@functools.lru_cache(maxsize=None)
def _reference_params(arch, seed=0):
    """The reference's initial weights (jit: eager init is slow)."""
    jcfg = _configs(arch)[0]
    return jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(seed))


def _setup(arch, B=2, S=24, seed=0):
    jcfg, cfg = _configs(arch)
    jparams = _reference_params(arch, seed)
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(cfg, np_params, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
             "labels": torch.from_numpy(labels.astype(np.int64))}
    return jcfg, cfg, jparams, params, jbatch, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_reference(arch):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(arch)
    j_logits, _ = jax.jit(functools.partial(jlm.lm_logits, jcfg))(
        jparams, jbatch["tokens"])
    j_loss, _ = jax.jit(functools.partial(jlm.lm_loss, jcfg))(jparams, jbatch)
    with torch.no_grad():
        logits, _ = lm.lm_logits(cfg, params, batch["tokens"])
        loss, metrics = build_model(cfg).loss(params, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=0, atol=ATOL)
    assert set(metrics) == {"loss", "aux"}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradient_matches_reference(arch):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(arch)
    j_grads = jax.jit(jax.grad(lambda p: jlm.lm_loss(jcfg, p, jbatch)[0]))(
        jparams)
    leaves = [l.requires_grad_(True) for _, l in tree_items(params)]
    loss, _ = lm.lm_loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for g, jg in zip(grads, j_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-3,
                                   atol=ATOL)


@pytest.mark.parametrize("window, cap", [(0, 0.0), (300, 50.0)])
def test_chunked_attention_matches_reference(window, cap):
    """Keys longer than one _CHUNK take the online-softmax path."""
    rng = np.random.default_rng(5)
    B, S, nq, nkv, hd = 1, 1100, 4, 2, 16
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32)
               for h in (nq, nkv, nkv))
    pos = np.arange(S, dtype=np.int32)
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                        window=window, cap=cap)
    got = attn.attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), q_pos=torch.from_numpy(pos),
                      kv_pos=torch.from_numpy(pos), window=window, cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_layout_matches_reference(arch):
    """The flat view of the same stacked params is column-for-column the
    reference's ConsensusEngine.flatten."""
    jcfg, cfg, jparams, params, _, _ = _setup(arch)
    M = 2
    jstacked = jax.tree.map(lambda a: jnp.stack([a, a * 0.5]), jparams)
    stacked = tree_from_items([(path, torch.stack([leaf, leaf * 0.5]))
                               for path, leaf in tree_items(params)])
    j = JEngine.from_stacked(jstacked)
    p = ConsensusEngine.from_stacked(stacked)
    np.testing.assert_array_equal(p.flatten(stacked).numpy(),
                                  np.asarray(j.flatten(jstacked)))
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert list(p.layout.paths) == paths
    assert p.layout.M == M


def test_params_from_numpy_checks_the_tree():
    cfg = reduced(get_arch("yi-6b"))
    np_params = jax.tree.map(np.asarray, _reference_params("yi-6b"))
    extra = dict(np_params, bogus=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(cfg, extra, device="cpu")
    missing = {k: v for k, v in np_params.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(cfg, missing, device="cpu")
    bad = dict(np_params, final_norm=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, bad, device="cpu")


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(reduced(get_arch("dbrx-132b")))


def _full_tree_matches_reference(name):
    """(the port's meta tree as {path: leaf}, its parameter count) after
    holding its paths, shapes and dtypes against the reference's."""
    jcfg, cfg = jget_arch(name), get_arch(name)
    want = jax.eval_shape(lambda k: jlm.init_lm(jcfg, k),
                          jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(tree_items(lm.init_lm(cfg, None, device="meta")))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == \
            want[path].dtype.name, path
    return got, sum(leaf.numel() for leaf in got.values())


# zamba2-7b's tree, counted from the reference's init (jax.eval_shape)
ZAMBA2_PARAMS = 5_737_416_000
ZAMBA2_PARAM_COUNT = 5_767_569_920      # what ModelConfig.param_count() says


def test_full_zamba2_tree_matches_reference_shapes():
    """The port's full-size zamba2-7b parameter tree, built on the meta
    device (nothing allocated), has the reference's paths, shapes and
    dtypes, and 5,737,416,000 parameters: 68 Mamba2 blocks and one shared
    attention + MLP block."""
    got, n = _full_tree_matches_reference("zamba2-7b")
    assert n == ZAMBA2_PARAMS
    assert got[("blocks", "cycle", "b0", "in_proj")].shape == (
        13, 3584, 2 * 7168 + 2 * 64 + 112)
    assert sorted({p[2] for p in got if p[1:2] == ("remainder",)}) == [
        "b0", "b1", "b2"]
    assert got[("blocks", "remainder", "b2", "in_proj")].shape == (
        3584, 2 * 7168 + 2 * 64 + 112)


def test_reference_param_count_overcounts_mamba_blocks():
    """A fault of the reference (ROADMAP.md Queue 3): ``param_count()``
    counts ``2 d_in N`` for a Mamba block's in_proj where the tree holds
    ``2 d N``, and leaves out conv_b, norm, A_log, D and dt_bias: 443,440
    too many per zamba2-7b Mamba block, 30,153,920 over 68 blocks."""
    jcfg = jget_arch("zamba2-7b")
    tree = jax.eval_shape(lambda k: jlm.init_lm(jcfg, k),
                          jax.random.PRNGKey(0))
    n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))
    assert n == ZAMBA2_PARAMS
    assert jcfg.param_count() == ZAMBA2_PARAM_COUNT
    n_mamba = jcfg.blocks().count("mamba")
    assert n_mamba == 68
    assert (ZAMBA2_PARAM_COUNT - ZAMBA2_PARAMS) == 443_440 * n_mamba


# xlstm-350m's tree, counted from the reference's init (jax.eval_shape)
XLSTM_PARAMS = 555_246_736
XLSTM_PARAM_COUNT = 303_219_712         # what ModelConfig.param_count() says


def test_full_xlstm_tree_matches_reference_shapes():
    """The port's full-size xlstm-350m tree on the meta device: the
    reference's paths, shapes and dtypes, 555,246,736 parameters
    (529,736,704 bf16 and 25,510,032 fp32) in 6 cycles of (mlstm, mlstm,
    mlstm, slstm), d_in 2048 over 4 heads of 512."""
    got, n = _full_tree_matches_reference("xlstm-350m")
    assert n == XLSTM_PARAMS
    by_dtype = {}
    for leaf in got.values():
        by_dtype[leaf.dtype] = by_dtype.get(leaf.dtype, 0) + leaf.numel()
    assert by_dtype == {torch.bfloat16: 529_736_704,
                        torch.float32: 25_510_032}
    assert sorted({p[2] for p in got if p[1:2] == ("cycle",)}) == [
        "b0", "b1", "b2", "b3"]
    assert not any(p[1:2] == ("remainder",) for p in got)
    assert got[("blocks", "cycle", "b3", "r_gates")].shape == (6, 4, 512,
                                                               2048)
    assert got[("blocks", "cycle", "b3", "r_gates")].dtype == torch.float32
    assert got[("blocks", "cycle", "b0", "wq")].shape == (6, 2048, 2048)
    assert got[("embed",)].shape == (50304, 1024)
    assert ("lm_head",) not in got                 # tied embeddings


def test_reference_param_count_undercounts_xlstm_blocks():
    """A fault of the reference (ROADMAP.md Queue 3): ``param_count()``
    counts ``4 d d_in + d_in d + 2 d`` per xLSTM block: twice the up
    projection's ``2 d d_in``, the down projection and two norms of d,
    where a block has one norm of d and one of d_in. It leaves out an
    mLSTM block's wq, wk, wv (3 d_in^2), w_i, w_f (2 d_in H) and b_i, b_f
    (2 H), and an sLSTM block's w_gates (4 d_in^2), r_gates (4 H P^2) and
    b_gates (4 d_in): 8,406,024 too few per mLSTM block and 16,786,432
    per sLSTM block, 252,027,024 over 18 and 6 of them."""
    jcfg = jget_arch("xlstm-350m")
    tree = jax.eval_shape(lambda k: jlm.init_lm(jcfg, k),
                          jax.random.PRNGKey(0))
    n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))
    assert n == XLSTM_PARAMS
    assert jcfg.param_count() == XLSTM_PARAM_COUNT
    d, d_in, H, P = 1024, 2048, 4, 512
    mlstm_missing = (3 * d_in * d_in + 2 * d_in * H + 2 * H + d_in
                     - 2 * d * d_in - d)
    slstm_missing = (4 * d_in * d_in + 4 * H * P * P + 4 * d_in + d_in
                     - 2 * d * d_in - d)
    assert (mlstm_missing, slstm_missing) == (8_406_024, 16_786_432)
    blocks = jcfg.blocks()
    assert (blocks.count("mlstm"), blocks.count("slstm")) == (18, 6)
    assert XLSTM_PARAMS - XLSTM_PARAM_COUNT == (
        18 * mlstm_missing + 6 * slstm_missing) == 252_027_024


@pytest.mark.parametrize("reduce", [False, True])
def test_reference_slstm_bias_lands_on_one_head(reduce):
    """A fault of the reference (ROADMAP.md Queue 3): ``b_gates`` is laid
    out gate-major (z, i, f, o blocks of d_in = H P) but is added to the
    gate preactivations before their head-major reshape to (H, 4P). So at
    H = 4 the forget bias of 3 lands on all four gates of head 2 and on
    no gate of heads 0, 1 and 3. The port mirrors it."""
    from repro.models import xlstm as jxlstm
    from repro_torch.models import xlstm
    jcfg, cfg = jget_arch("xlstm-350m"), get_arch("xlstm-350m")
    if reduce:
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    d_in, H, P = jxlstm.dims(jcfg)
    assert H == 4 and xlstm.dims(cfg) == (d_in, H, P)
    want = np.zeros((H, 4))
    want[2] = 3.0
    jb = jxlstm.init_slstm(jax.random.PRNGKey(0), jcfg,
                           jnp.float32)["b_gates"]
    b = xlstm.init_slstm(torch.Generator().manual_seed(0), cfg,
                         torch.float32, device="cpu")["b_gates"]
    for bias in (np.asarray(jb), b.numpy()):
        np.testing.assert_array_equal(bias.reshape(H, 4, P).mean(-1), want)


def test_reference_mlstm_forgets_nothing_and_takes_no_new_writes():
    """A fault of the reference (ROADMAP.md Queue 3): the mLSTM forget
    gate is exponential (its preactivation is log f) with a bias of +3,
    so f ~ e^3 a step and the stabiliser m grows by ~3 a token; after a
    few tokens the matrix memory takes no new writes. On reduced
    xlstm-350m (the published per-step mLSTM), 64 random tokens: moving
    the input at token 32 leaves the last token's output unchanged to
    1e-6; moving token 0 moves it by more than 1. The port mirrors it."""
    from repro.models import xlstm as jxlstm
    from repro_torch.models import xlstm
    jcfg, cfg = jreduced(jget_arch("xlstm-350m")), reduced(
        get_arch("xlstm-350m"))
    assert jcfg.xlstm_chunk == 0
    jp = jxlstm.init_mlstm(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 64, jcfg.d_model)).astype(np.float32)
    dx = rng.normal(size=jcfg.d_model).astype(np.float32)

    def last(x):
        jo = np.asarray(jxlstm.mlstm_forward(jp, jnp.asarray(x), jcfg)[0])
        o = xlstm.mlstm_forward(p, torch.from_numpy(x), cfg)[0].numpy()
        return jo[:, -1], o[:, -1]

    base = last(x)
    for t, moves in ((32, False), (0, True)):
        x2 = x.copy()
        x2[:, t] += dx
        for got, want in zip(last(x2), base):
            diff = float(np.abs(got - want).max())
            assert (diff > 1.0) if moves else (diff < 1e-6), (t, diff)
