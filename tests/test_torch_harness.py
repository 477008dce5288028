"""The port's harness against the reference's: ``pullpush_fused`` on the
reference tests' trees, and ``repro_torch.benchmarks.common``'s
``run_distributed`` on the README quickstart (tree engine, flat engine,
DDP). The port's ``mlp_init`` is substituted by one that returns the
reference's ``mlp_init(PRNGKey(seed))`` carried across with
``mlp_params_from_numpy``, so both packages start from the same weights."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as jcommon
from repro.configs import DPPFConfig as JDPPFConfig
from repro.core import pullpush as jpp
from repro.kernels.pullpush import pullpush_fused as jpullpush_fused
from repro_torch.benchmarks import common
from repro_torch.configs import DPPFConfig
from repro_torch.core import pullpush as pp
from repro_torch.kernels.pullpush import pullpush_fused
from repro_torch.kernels.pullpush import pullpush as pk


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the module: the benchmark MLP's ops are tiny,
    and the test workers share the host's cores (with a thread pool each,
    they spin against one another)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried_init(gen, dim, n_classes, width=64, depth=2, *, device):
    p = jcommon.mlp_init(jax.random.PRNGKey(gen.initial_seed()), dim,
                         n_classes, width, depth)
    return common.mlp_params_from_numpy(jax.tree.map(np.asarray, p),
                                        device=device)


@pytest.fixture
def carried(monkeypatch):
    monkeypatch.setattr(common, "mlp_init", _carried_init)


def _torch_tree(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# pullpush_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [None, True])
def test_pullpush_fused_matches_reference(use_kernel):
    """``tests/test_kernels.py::test_pullpush_fused_matches_core``'s tree:
    the port's wrapper (the engine's precise stage, or ``fused_round``'s
    plain version) against the reference's (its Pallas kernel in
    interpret mode) and against the port's tree ``pullpush``, at that
    test's 1e-5."""
    key = jax.random.PRNGKey(0)
    jstacked = {"w": jax.random.normal(key, (4, 33, 65)),
                "b": jax.random.normal(jax.random.fold_in(key, 1), (4, 17))}
    stacked = _torch_tree(jstacked)
    want, jr = jpullpush_fused(jstacked, 0.1, 0.5)
    got, r = pullpush_fused(stacked, 0.1, 0.5, use_kernel=use_kernel)
    tree, _ = pp.pullpush(stacked, 0.1, 0.5)
    for k in jstacked:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[k].numpy(), tree[k].numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(r.numpy(), pp.worker_dists(stacked).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [None, True])
def test_pullpush_fused_exact_near_consensus(use_kernel):
    """``tests/test_engine.py::test_pullpush_fused_exact_near_consensus``:
    workers 1e-5 apart, coef ~ -800; both routes keep plain Eq. 5 (no
    fast-path floor): r within 1e-3 of the exact distances, the trees
    within that test's 2e-3 of the reference's tree ``pullpush``."""
    key = jax.random.PRNGKey(1)
    M, n = 8, 4096
    base = jax.random.normal(key, (n,))
    jstacked = {"w": base[None] + 1e-5 * jax.random.normal(
        jax.random.fold_in(key, 1), (M, n))}
    want, _ = jpp.pullpush(jstacked, 0.1, 0.5)
    got, r = pullpush_fused(_torch_tree(jstacked), 0.1, 0.5,
                            use_kernel=use_kernel)
    np.testing.assert_allclose(r.numpy(),
                               np.asarray(jpp.worker_dists(jstacked)),
                               rtol=1e-3)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               atol=2e-3)


def test_pullpush_fused_keeps_each_leaf_dtype():
    """A bf16 leaf goes through the fp32 view and comes back bf16, within
    one bf16 rounding of the tree route (``apply_update`` on bf16 rows)."""
    g = torch.Generator().manual_seed(3)
    stacked = {"a": torch.randn(4, 300, generator=g).to(torch.bfloat16),
               "b": torch.randn(4, 7, 5, generator=g)}
    got, _ = pullpush_fused(stacked, 0.2, 0.3)
    tree, _ = pp.pullpush(stacked, 0.2, 0.3)
    assert got["a"].dtype == torch.bfloat16 and got["b"].dtype == torch.float32
    a, t = got["a"].to(torch.float32), tree["a"].to(torch.float32)
    ulp = torch.abs(t) * 2.0 ** -7
    assert bool(torch.all(torch.abs(a - t) <= ulp + 1e-30))
    np.testing.assert_allclose(got["b"].numpy(), tree["b"].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_pullpush_fused_launches_nothing_on_cpu():
    """On a CPU tree the wrapper runs the plain route: no launch is
    counted (a CUDA tree counts exactly one ``fused_round``; chip_smoke.py
    phase 14 pins it)."""
    pk.reset_launches()
    stacked = {"w": torch.randn(4, 64)}
    pullpush_fused(stacked, 0.1, 0.5)
    assert all(v == 0 for v in pk.LAUNCHES.values())


# ---------------------------------------------------------------------------
# run_distributed
# ---------------------------------------------------------------------------

QUICKSTART = [
    ("tree", dict(alpha=0.1, lam=0.5, tau=4), 300),
    ("flat", dict(alpha=0.1, lam=0.5, tau=4, engine="flat"), 300),
    ("ddp", dict(consensus="ddp"), 100),
]


@pytest.mark.parametrize("name, dkw, steps", QUICKSTART,
                         ids=[q[0] for q in QUICKSTART])
def test_quickstart_matches_reference(carried, name, dkw, steps):
    """README quickstart (M = 4, alpha 0.1, lam 0.5, tau 4) through both
    packages' ``run_distributed`` from the same weights: the width within
    1e-3, ``params_avg``'s train and test errors within 0.5 points, the
    communication share equal. Parameters are not compared entry by entry
    after 300 steps: the reference's own run moves by more than 1e-3 under
    a 1e-7 change of its init (``tests/test_torch_tree.py``,
    ``test_reference_quickstart_params_move_under_a_tiny_perturbation``)."""
    want = jcommon.run_distributed(jcommon.default_data(),
                                   JDPPFConfig(**dkw), M=4, steps=steps)
    got = common.run_distributed(common.default_data(device="cpu"),
                                 DPPFConfig(**dkw), M=4, steps=steps)
    assert abs(got.consensus_dist - want.consensus_dist) < 1e-3
    assert abs(got.train_err - want.train_err) <= 0.5
    assert abs(got.test_err - want.test_err) <= 0.5
    assert got.gen_gap == got.test_err - got.train_err
    assert got.comm_pct == want.comm_pct
    assert len(got.workers) == len(want.workers)
    if name == "ddp":
        assert got.consensus_dist == 0.0 and got.comm_pct == 100.0


@pytest.mark.parametrize("name, dkw, steps", [
    ("tree", dict(alpha=0.1, lam=0.5, tau=4), 12),
    ("flat", dict(alpha=0.1, lam=0.5, tau=4, engine="flat"), 12),
    ("ddp", dict(consensus="ddp"), 6),
    ("tree_qsr_sam", dict(alpha=0.1, lam=0.5, tau=2, qsr_beta=0.4), 10),
], ids=lambda v: v if isinstance(v, str) else None)
def test_first_rounds_params_match_reference(carried, name, dkw, steps):
    """The first rounds, parameter by parameter: ``params_avg`` and every
    worker within 1e-5 of the reference's (the last case adds a QSR round
    plan and SAM). The tracked metrics match at 1e-5, except the flat
    engine's: its fast mode reads the distances off an uncentered fp32
    Gram, whose rounding (~eps32 x the largest squared row norm, summed
    in another order in each package) moves them by ~2e-4 here; they are
    held to 1e-3."""
    sam = 0.05 if name.endswith("sam") else 0.0
    want = jcommon.run_distributed(jcommon.default_data(),
                                   JDPPFConfig(**dkw), M=4, steps=steps,
                                   sam_rho=sam, track_every=1)
    got = common.run_distributed(common.default_data(device="cpu"),
                                 DPPFConfig(**dkw), M=4, steps=steps,
                                 sam_rho=sam, track_every=1)
    for mine, ref in [(got.params_avg, want.params_avg)] + list(
            zip(got.workers, want.workers)):
        for l, d in ref.items():
            for k, v in d.items():
                np.testing.assert_allclose(mine[l][k].numpy(), np.asarray(v),
                                           rtol=1e-5, atol=1e-5)
    assert got.history["step"] == want.history["step"]
    rtol = 1e-3 if name == "flat" else 1e-5
    for k in ("consensus_dist", "pull", "push", "lam"):
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=rtol, atol=1e-6)
    assert got.comm_pct == want.comm_pct


def test_harness_pieces_match_reference():
    """The data, the shards, one round's batch, ``mlp_loss`` and
    ``error_pct`` on the same weights; ``mlp_init`` draws from the
    generator in layer order, so one seed gives one model."""
    jdata = jcommon.default_data()
    data = common.default_data(device="cpu")
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(jdata[k]))
    shards = common.worker_shards(len(data["x_train"]), 4, 3)
    for a, b in zip(shards, jcommon.worker_shards(len(jdata["x_train"]),
                                                  4, 3)):
        np.testing.assert_array_equal(a, b)
    b = common.round_batches(data, shards, np.random.default_rng(5), 3, 4, 8)
    jb = jcommon.round_batches(jdata, shards, np.random.default_rng(5), 3,
                               4, 8)
    assert b["y"].dtype == torch.int64 and b["x"].shape == (3, 4, 8, 32)
    np.testing.assert_array_equal(b["x"].numpy(), np.asarray(jb["x"]))
    np.testing.assert_array_equal(b["y"].numpy(), np.asarray(jb["y"]))

    jp = jcommon.mlp_init(jax.random.PRNGKey(2), 32, 10, 16)
    p = common.mlp_params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    batch = {k: v[0, 1] for k, v in b.items()}
    jloss, jaux = jcommon.mlp_loss(jp, {k: v[0, 1] for k, v in jb.items()})
    loss, aux = common.mlp_loss(p, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert sorted(aux) == sorted(jaux)
    for split in ("train", "test"):
        x, y = data[f"x_{split}"], data[f"y_{split}"]
        assert common.error_pct(p, x, y) == jcommon.error_pct(
            jp, jdata[f"x_{split}"], jdata[f"y_{split}"])

    a = common.mlp_init(torch.Generator().manual_seed(7), 32, 10, 16,
                        device="cpu")
    b2 = common.mlp_init(torch.Generator().manual_seed(7), 32, 10, 16,
                         device="cpu")
    assert sorted(a) == ["l0", "l1", "l2"]
    for l in a:
        assert torch.equal(a[l]["w"], b2[l]["w"])
        assert not torch.any(a[l]["b"])
    assert a["l0"]["w"].shape == (32, 16) and a["l2"]["w"].shape == (16, 10)


def test_error_pct_breaks_ties_by_the_first_index():
    """Tied logits: both packages predict the first maximal class."""
    p = {"l0": {"w": torch.zeros(4, 3), "b": torch.zeros(3)}}
    x = torch.ones(5, 4)
    y = torch.tensor([0, 1, 2, 0, 0])
    jp = {"l0": {"w": jnp.zeros((4, 3)), "b": jnp.zeros((3,))}}
    assert common.error_pct(p, x, y) == pytest.approx(40.0)
    assert common.error_pct(p, x, y) == jcommon.error_pct(
        jp, jnp.ones((5, 4)), jnp.asarray(y.numpy()))
