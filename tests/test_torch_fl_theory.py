"""The port's ``core/theory.py`` and ``core/fl.py`` against the reference's
on the same numpy inputs: Theorem 1's width and the proof recurrence
(bit-equal), Algorithm 3's landscape scan, the Dirichlet partition, and FL
rounds of FedAvg / SCAFFOLD / FedLESAM with and without the DPPF
aggregation."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as jcommon
from repro.configs import DPPFConfig as JDPPFConfig
from repro.core import fl as jfl
from repro.core import theory as jtheory
from repro_torch.benchmarks import common
from repro_torch.configs import DPPFConfig
from repro_torch.core import fl, theory

from test_torch_harness import one_thread  # noqa: F401 (a fixture)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _close_tree(got, want, tol, what=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _close_tree(got[k], v, tol, f"{what}/{k}")
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{what}/{k}")


# ---------------------------------------------------------------------------
# theory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha, lam, M", [(0.1, 0.5, 4), (0.1, 0.5, 32),
                                           (0.5, 2.5, 8), (0.2, 0.2, 8)])
def test_width_recurrence_is_bit_equal(alpha, lam, M):
    """theorem1_width's grid (400 rounds): the same numpy bits, and the
    same predicted width and Eq. 22 bound."""
    kw = dict(eta=0.01, tau=4, sigma0=1.0, M=M, rounds=400)
    got = theory.width_recurrence(alpha, lam, **kw)
    np.testing.assert_array_equal(got, jtheory.width_recurrence(alpha, lam,
                                                                **kw))
    assert theory.predicted_width(alpha, lam) == \
        jtheory.predicted_width(alpha, lam)
    assert theory.width_upper_bound(alpha, lam, 0.01, 4, 1.0, M) == \
        jtheory.width_upper_bound(alpha, lam, 0.01, 4, 1.0, M)


@pytest.fixture(scope="module")
def workers():
    """Four workers of a short reference run (tree engine, 16 steps,
    width 16) as numpy, and the train set."""
    data = jcommon.default_data()
    r = jcommon.run_distributed(data, JDPPFConfig(alpha=0.1, lam=0.5, tau=4),
                                M=4, steps=16, width=16)
    return data, [jax.tree.map(np.asarray, w) for w in r.workers]


@pytest.mark.parametrize("M", [2, 4])
def test_landscape_scan_matches_reference(workers, M):
    """Algorithm 3 on the MLP's train loss (the first 512 samples), a 5 x 5
    grid: the scan within 1e-5, the grid, the workers' coordinates and the
    SVD plane equal (the same numpy SVD of the same fp32 gaps)."""
    data, ws = workers
    x = np.asarray(data["x_train"])[:512]
    y = np.asarray(data["y_train"])[:512]
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    b = {"x": torch.tensor(x), "y": torch.tensor(y.astype(np.int64))}
    want = jtheory.landscape_scan(lambda p: jcommon.mlp_loss(p, jb)[0],
                                  [jax.tree.map(jnp.asarray, w)
                                   for w in ws[:M]], lim=0.5, step=0.25)
    got = theory.landscape_scan(lambda p: common.mlp_loss(p, b)[0],
                                [_t(w) for w in ws[:M]], lim=0.5, step=0.25)
    np.testing.assert_array_equal(got["grid"], want["grid"])
    np.testing.assert_array_equal(got["worker_coords"],
                                  want["worker_coords"])
    for a, c in zip(got["dirs"], want["dirs"]):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_allclose(got["scan"], want["scan"], rtol=1e-5,
                               atol=1e-6)


def test_landscape_scan_needs_two_workers():
    """The reference's one-worker branch (``theory.py:80``) parses as ``v2
    = (vt[1] if vt.shape[0] > 1 else (vt[0], vt[0]))``: v2 becomes a tuple
    and the projection fails on a shape error. The port refuses one
    worker with a ValueError that says why."""
    one = [{"x": np.ones(4, np.float32)}]
    with pytest.raises(ValueError, match="mismatch in its core dimension"):
        jtheory.landscape_scan(lambda p: jnp.sum(p["x"]),
                               [jax.tree.map(jnp.asarray, w) for w in one])
    with pytest.raises(ValueError, match="at least 2 workers"):
        theory.landscape_scan(lambda p: torch.sum(p["x"]),
                              [_t(w) for w in one])


# ---------------------------------------------------------------------------
# FL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dir_alpha, M, seed", [(0.1, 4, 0), (0.6, 4, 182),
                                                (0.3, 8, 437)])
def test_dirichlet_partition_is_index_equal(dir_alpha, M, seed):
    labels = np.asarray(jcommon.default_data()["y_train"])
    got = fl.dirichlet_partition(torch.tensor(labels.astype(np.int64)), M,
                                 dir_alpha, seed=seed)
    want = jfl.dirichlet_partition(labels, M, dir_alpha, seed=seed)
    assert len(got) == len(want) == M
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert fl.heterogeneity(got, labels, 10) == \
        jfl.heterogeneity(want, labels, 10)


FL_CASES = [(m, d) for m in ("fedavg", "scaffold", "fedlesam")
            for d in (False, True)]


@pytest.mark.parametrize("method, dppf", FL_CASES,
                         ids=[f"{m}-{'dppf' if d else 'avg'}"
                              for m, d in FL_CASES])
def test_fl_rounds_match_reference(method, dppf):
    """Two rounds (M = 4, tau = 3, bs 16, width 16, lr 0.25, Dirichlet 0.6
    shards) from the same stacked weights: the workers, the server state
    (x_prev_global, SCAFFOLD's c and c_m) and the consensus distance within
    1e-5. The second round runs on the first one's control variates."""
    M, tau, bs, lr = 4, 3, 16, 0.25
    data = jcommon.default_data()
    x, y = np.asarray(data["x_train"]), np.asarray(data["y_train"])
    shards = jfl.dirichlet_partition(y, M, 0.6, seed=0)
    p0 = jcommon.mlp_init(jax.random.PRNGKey(0), 32, 10, 16)
    jst = jax.tree.map(lambda a: jnp.array(jnp.broadcast_to(
        a[None], (M,) + a.shape)), p0)
    st = _t(jax.tree.map(np.asarray, jst))
    jstate, state = jfl.init_fl_state(method, jst), fl.init_fl_state(
        method, st)
    kw = dict(alpha=0.9, lam=1.8, tau=tau)
    jd, d = (JDPPFConfig(**kw), DPPFConfig(**kw)) if dppf else (None, None)
    jloss = lambda p, b: jcommon.mlp_loss(p, b)[0]
    loss = lambda p, b: common.mlp_loss(p, b)[0]
    rng = np.random.default_rng(5)
    for r in range(2):
        idx = np.stack([[rng.choice(shards[m], bs) for m in range(M)]
                        for _ in range(tau)])
        lam = 1.8 * (r + 1) / 2 if dppf else 0.0
        jst, jstate, jm = jfl.fl_round(
            method, jloss, jst, jstate,
            {"x": jnp.asarray(x[idx]), "y": jnp.asarray(y[idx])}, lr,
            dppf=jd, lam_t=jnp.float32(lam))
        st, state, m = fl.fl_round(
            method, loss, st, state,
            {"x": torch.tensor(x[idx]),
             "y": torch.tensor(y[idx].astype(np.int64))}, lr,
            dppf=d, lam_t=lam)
        _close_tree(st, jst, 1e-5, f"round {r} params")
        assert sorted(state) == sorted(jstate)
        for k in jstate:
            _close_tree(state[k], jstate[k], 1e-5, f"round {r} {k}")
        np.testing.assert_allclose(float(m["consensus_dist"]),
                                   float(jm["consensus_dist"]), rtol=1e-5,
                                   atol=1e-6)
    if method == "scaffold":
        assert all(v.dtype == torch.float32 for l in state["c_m"].values()
                   for v in l.values())
    if not dppf:   # FedAvg resets every worker to the average
        for l in st.values():
            for v in l.values():
                assert torch.equal(v[0], v[3])
