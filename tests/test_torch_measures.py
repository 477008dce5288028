"""The port's Mean Valley (``core/valley.py``) and sharpness measures
(``core/sharpness.py``) against the reference's on the same numpy inputs:
the quadratics of ``tests/test_valley_sharpness.py`` and workers of the
benchmark MLP. Where a measure draws random vectors, the reference's draws
are substituted for the port's generator (``sharpness._normal`` /
``_rademacher``), so both packages see the same vectors."""
from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import benchmarks.common as jcommon
from repro.configs import DPPFConfig as JDPPFConfig
from repro.core import sharpness as jsh
from repro.core import valley as jvalley
from repro_torch.benchmarks import common
from repro_torch.core import sharpness as sh
from repro_torch.core import valley

from test_torch_harness import one_thread  # noqa: F401 (a fixture)


def _t(tree):
    """A numpy / jax tree of dicts as torch tensors (CPU)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _quad(curv, xp):
    c = xp.asarray(np.asarray(curv, np.float32))
    return lambda p: 0.5 * xp.sum(c * p["x"] * p["x"]) + 1.0


def _same_valley(got, want, tol=1e-5):
    np.testing.assert_allclose(got["betas"], want["betas"], rtol=tol,
                               atol=tol)
    assert got["hit_boundary"] == want["hit_boundary"]
    np.testing.assert_allclose(got["mv"], want["mv"], rtol=tol, atol=tol)
    assert got["inv_mv"] == -got["mv"]
    np.testing.assert_allclose(got["loss_at_avg"], want["loss_at_avg"],
                               rtol=1e-6)
    assert got["kappa"] == want["kappa"] and sorted(got) == sorted(want)


# the cases of tests/test_valley_sharpness.py and an anisotropic one with
# normalization: (curvatures, workers, kwargs), workers as numpy
VALLEY_CASES = {
    "isotropic": ([0.5] * 8, [np.eye(8, dtype=np.float32)[i] * 0.3
                              for i in range(4)],
                  dict(kappa=2.0, step=0.02, max_steps=400)),
    "bisection": ([0.5] * 8, [np.eye(8, dtype=np.float32)[0] * 0.3,
                              -np.eye(8, dtype=np.float32)[0] * 0.3],
                  dict(kappa=2.0, step=0.5, max_steps=20)),
    "flat_sharp": ([0.1] * 6, [np.eye(6, dtype=np.float32)[i] * 0.2
                               for i in range(3)],
                   dict(step=0.05, max_steps=500)),
    "sharp": ([5.0] * 6, [np.eye(6, dtype=np.float32)[i] * 0.2
                          for i in range(3)],
              dict(step=0.05, max_steps=500)),
    "anisotropic_normalized": ([0.3, 2.0, 0.7, 5.0],
                               [np.array([1.0, 2.0, -1.0, 0.5], np.float32),
                                np.array([-0.5, 1.0, 2.0, 0.0], np.float32),
                                np.array([0.2, -1.0, 0.3, 1.5], np.float32)],
                               dict(step=0.05, max_steps=400,
                                    normalize=True)),
}


@pytest.mark.parametrize("case", sorted(VALLEY_CASES))
def test_mean_valley_matches_reference_on_quadratics(case):
    """Betas, flags, MV and L_A within 1e-5 of the reference's."""
    curv, ws, kw = VALLEY_CASES[case]
    want = jvalley.mean_valley(_quad(curv, jnp),
                               [{"x": jnp.asarray(w)} for w in ws], **kw)
    got = valley.mean_valley(_quad(curv, torch),
                             [{"x": torch.tensor(w)} for w in ws], **kw)
    _same_valley(got, want)


def test_mean_valley_saturation_and_zero_direction():
    """A constant loss never crosses: every direction saturates at
    ``max_steps * step`` and is flagged; a worker at the average is not."""
    flat = lambda p: 1.0 + 0.0 * torch.sum(p["x"])
    jflat = lambda p: 1.0 + 0.0 * jnp.sum(p["x"])
    ws = [np.eye(4, dtype=np.float32)[i] for i in range(2)]
    got = valley.mean_valley(flat, [{"x": torch.tensor(w)} for w in ws],
                             kappa=2.0, step=0.1, max_steps=30)
    want = jvalley.mean_valley(jflat, [{"x": jnp.asarray(w)} for w in ws],
                               kappa=2.0, step=0.1, max_steps=30)
    _same_valley(got, want)
    assert got["hit_boundary"] == [True, True]
    zero = [{"x": torch.zeros(4)}, {"x": torch.zeros(4)}]
    res = valley.mean_valley(flat, zero, kappa=2.0, step=0.1, max_steps=5)
    assert res["hit_boundary"] == [False, False] and res["mv"] == 0.0


def test_normalize_params_matches_reference():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3) - 2.0,
            "b": np.zeros(3, np.float32),
            "c": np.asarray([3.0, 4.0], np.float32)}
    got = valley.normalize_params(_t(tree))
    want = jvalley.normalize_params(jax.tree.map(jnp.asarray, tree))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-7, atol=0)
    assert not torch.any(got["b"])


@pytest.fixture(scope="module")
def mlp():
    """A short reference quickstart run (tree engine, 40 steps, width 32):
    its workers and average as numpy, and the full train set."""
    data = jcommon.default_data()
    r = jcommon.run_distributed(data, JDPPFConfig(alpha=0.1, lam=0.5, tau=4),
                                M=4, steps=40, width=32)
    workers = [jax.tree.map(np.asarray, w) for w in r.workers]
    avg = jax.tree.map(np.asarray, r.params_avg)
    return data, workers, avg


def _full(data, xp, n=None):
    x, y = np.asarray(data["x_train"]), np.asarray(data["y_train"])
    if n:
        x, y = x[:n], y[:n]
    if xp is torch:
        return {"x": torch.tensor(x), "y": torch.tensor(y.astype(np.int64))}
    return {"x": jnp.asarray(x), "y": jnp.asarray(y)}


@pytest.mark.parametrize("normalize", [False, True])
def test_mean_valley_matches_reference_on_mlp_workers(mlp, normalize):
    """Table 1's setting (kappa 2, step 0.05, max 120 steps) on four MLP
    workers and its loss (the first 1024 train samples): betas within
    1e-5."""
    data, workers, _ = mlp
    fb, jfb = _full(data, torch, 1024), _full(data, jnp, 1024)
    kw = dict(kappa=2.0, step=0.05, max_steps=120, normalize=normalize)
    want = jvalley.mean_valley(lambda p: jcommon.mlp_loss(p, jfb)[0],
                               [jax.tree.map(jnp.asarray, w)
                                for w in workers], **kw)
    got = valley.mean_valley(lambda p: common.mlp_loss(p, fb)[0],
                             [_t(w) for w in workers], **kw)
    _same_valley(got, want)


# ---------------------------------------------------------------------------
# sharpness
# ---------------------------------------------------------------------------

def _loss_pair(data):
    fb, jfb = _full(data, torch, 1024), _full(data, jnp, 1024)
    return (lambda p, b: common.mlp_loss(p, b)[0], fb,
            lambda p, b: jcommon.mlp_loss(p, b)[0], jfb)


def test_flat_order_is_the_reference_leaf_order(mlp):
    _, _, avg = mlp
    np.testing.assert_array_equal(sh._flat(_t(avg)).numpy(),
                                  np.asarray(jsh._flat(avg)))
    v = torch.arange(sh._flat(_t(avg)).numel(), dtype=torch.float32)
    back = sh._unflat(v, _t(avg))
    jback = jsh._unflat(jnp.asarray(v.numpy()), avg)
    for l in avg:
        for k in avg[l]:
            np.testing.assert_array_equal(back[l][k].numpy(),
                                          np.asarray(jback[l][k]))


def test_entropy_and_eps_sharpness_match_reference(mlp):
    """Deterministic measures: the entropy at 1e-5 relative; eps-sharpness
    at 2e-5 absolute, since it is 100 (L_max - L) / (1 + L) for two losses
    3e-5 apart, so one fp32 rounding of either (~2e-7 at L ~ 1.3) moves
    it by ~1e-5."""
    data, _, avg = mlp
    loss, fb, jloss, jfb = _loss_pair(data)
    logit = lambda p, b: common.mlp_logits(p, b["x"])
    jlogit = lambda p, b: jcommon.mlp_logits(p, b["x"])
    batches = [_full(data, torch, 256), fb]
    jbatches = [_full(data, jnp, 256), jfb]
    np.testing.assert_allclose(
        sh.shannon_entropy(logit, _t(avg), batches),
        jsh.shannon_entropy(jlogit, avg, jbatches), rtol=1e-5)
    np.testing.assert_allclose(sh.eps_sharpness(loss, _t(avg), fb),
                               jsh.eps_sharpness(jloss, avg, jfb),
                               rtol=0, atol=2e-5)


def test_hvp_and_fisher_rao_match_reference(mlp):
    """H v on the MLP (ReLU kinks included) and <x, Hx>, against the
    reference's forward-over-reverse product: 1e-4 relative to the
    largest entry of H v, 1e-4 relative for <x, Hx>; and on a quadratic,
    where H = diag(c) exactly."""
    data, _, avg = mlp
    loss, fb, jloss, jfb = _loss_pair(data)
    p, dim = _t(avg), sh._flat(_t(avg)).numel()
    v = np.random.default_rng(0).normal(size=dim).astype(np.float32)
    hv = sh._flat(sh.hvp_fn(loss, p, fb)(sh._unflat(torch.tensor(v), p)))
    jhv = jsh._flat(jsh.hvp_fn(jloss, avg, jfb)(
        jsh._unflat(jnp.asarray(v), avg)))
    scale = float(np.max(np.abs(np.asarray(jhv))))
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(sh.fisher_rao(loss, p, fb),
                               jsh.fisher_rao(jloss, avg, jfb), rtol=1e-4)

    c = np.asarray([0.5, 2.0, 3.0], np.float32)
    x = np.asarray([1.0, -2.0, 0.5], np.float32)
    q = lambda p, b: 0.5 * torch.sum(torch.tensor(c) * p["x"] ** 2)
    np.testing.assert_allclose(sh.fisher_rao(q, {"x": torch.tensor(x)},
                                             None),
                               float(np.sum(c * x * x)), rtol=1e-6)


class _Draws:
    """Stand-in for ``sharpness._normal`` / ``_rademacher``: hands out the
    given arrays in order, as tensors on the asked device."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, gen, shape, device):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape)
        return torch.tensor(np.asarray(a)).to(device)


def test_lpf_matches_reference_with_the_same_draws(mlp, monkeypatch):
    """LPF (sigma 0.01, 10 samples) with the reference's noise draws:
    1e-6 relative."""
    data, _, avg = mlp
    loss, fb, jloss, jfb = _loss_pair(data)
    key = jax.random.PRNGKey(3)
    dim = sh._flat(_t(avg)).numel()
    monkeypatch.setattr(sh, "_normal", _Draws(
        jax.random.normal(jax.random.fold_in(key, i), (dim,))
        for i in range(10)))
    got = sh.lpf(loss, _t(avg), fb, torch.Generator(), mcmc=10)
    np.testing.assert_allclose(got, jsh.lpf(jloss, avg, jfb, key, mcmc=10),
                               rtol=1e-6)


def test_hessian_measures_match_reference_with_the_same_draws(
        mlp, monkeypatch):
    """lambda_max (Lanczos, 10 iterations), trace and Frobenius norm
    (Hutchinson, 4 samples) with the reference's start vector and
    Rademacher vectors: 1e-4 relative."""
    data, _, avg = mlp
    loss, fb, jloss, jfb = _loss_pair(data)
    key = jax.random.PRNGKey(5)
    dim = sh._flat(_t(avg)).numel()
    monkeypatch.setattr(sh, "_normal",
                        _Draws([jax.random.normal(key, (dim,))]))
    monkeypatch.setattr(sh, "_rademacher", _Draws(
        jax.random.rademacher(jax.random.fold_in(key, 1000 + i), (dim,),
                              dtype=jnp.float32) for i in range(4)))
    got = sh.hessian_measures(loss, _t(avg), fb, torch.Generator(),
                              lanczos_iters=10, hutchinson=4)
    want = jsh.hessian_measures(jloss, avg, jfb, key, lanczos_iters=10,
                                hutchinson=4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_lanczos_gives_the_exact_spectrum_of_a_quadratic():
    """On H = diag(c) with iters >= dim, Lanczos with full
    reorthogonalization returns the spectrum whatever the start: the
    port's own draws against the reference's, both against c."""
    c = np.asarray([0.1, 0.5, 1.0, 2.0, 3.5, 7.0], np.float32)
    got = sh.lanczos(lambda v: torch.tensor(c) * v, c.size,
                     torch.Generator().manual_seed(0), iters=8)
    want = jsh.lanczos(lambda v: jnp.asarray(c) * v, c.size,
                       jax.random.PRNGKey(0), iters=8)
    np.testing.assert_allclose(got, np.sort(c), rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_draws_are_the_same_on_every_device():
    """The generator draws on the CPU; the vectors are then moved, so one
    seed gives one vector wherever the parameters lie."""
    a = sh._normal(torch.Generator().manual_seed(4), (7,), "cpu")
    b = sh._normal(torch.Generator().manual_seed(4), (7,), torch.device(
        "cpu"))
    assert torch.equal(a, b) and a.dtype == torch.float32
    r = sh._rademacher(torch.Generator().manual_seed(4), (1000,), "cpu")
    assert set(r.tolist()) == {-1.0, 1.0}


@pytest.mark.parametrize("seed", range(4))
def test_kendall_tau_matches_scipy(seed):
    """tau-b, ties included (integer draws), against
    ``scipy.stats.kendalltau`` to 1e-12."""
    rng = np.random.default_rng(seed)
    n = 5 + 4 * seed
    a = rng.integers(0, 4, size=n).astype(float) if seed % 2 else \
        rng.normal(size=n)
    b = rng.integers(0, 3, size=n).astype(float) if seed > 1 else \
        rng.normal(size=n)
    np.testing.assert_allclose(sh.kendall_tau(a, b),
                               scipy.stats.kendalltau(a, b).statistic,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(sh.kendall_tau(list(a), list(b)),
                               jsh.kendall_tau(a, b), rtol=0, atol=1e-12)


def test_kendall_tau_degenerate_inputs_are_nan_as_in_scipy():
    for a, b in (([1.0, 1.0, 1.0], [1.0, 2.0, 3.0]), ([1.0], [2.0]),
                 ([1.0, np.nan, 2.0], [1.0, 2.0, 3.0])):
        assert np.isnan(sh.kendall_tau(a, b))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert np.isnan(scipy.stats.kendalltau(a, b).statistic)
