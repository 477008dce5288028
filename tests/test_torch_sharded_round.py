"""The port's sharded DPPF round (``make_sharded_round_step`` on gloo ranks,
``tests/_torch_dist.py``) against the reference's single-device round on
the same numpy inputs, on the quickstart MLP (dim 16, 4 classes, width 8).

One spawn of 8 CPU ranks runs every case on three meshes of that world:
flat 4x2 (M = 4: rows over 4 ranks, columns over 2), flat 8x1 and
hierarchical 2x2x2 (M = 8: columns over fsdp x model). The reference's
rounds run here in the pytest process. The bars are the reference's own
for its sharded legs (``tests/test_sharded_round.py:690-705, :800-810``):

* every method of the registry on 4x2, 2 rounds: fast dp < 2e-5 and dm <
  1e-4, precise dp <= 1e-7 and dm < 1e-6 (dp: largest parameter
  difference, dm: largest metric difference). Precise is held to that bar
  against the port's own single-device round (the ranks run it too; the
  sharded round adds no difference), and to eps32 * max(|x|, 1) an entry
  against the reference's: the packages' local steps round apart by that
  much (1.19e-7 at most here), sharded or not;
* the kernel route (its plain version on CPU tensors, through
  ``fused_round_sharded``) against the reference's Pallas kernel in
  interpret mode: dp < 2e-5;
* ``staleness1``, precise, 3 rounds: dp < 1e-6; ``doublebuf`` in one
  chunk, precise, from its round-0 bubble: dp < 1e-6 against the port's
  single-device round, 1e-5 against the reference's;
* the reference's doublebuf leg, within the port: from one warm
  ``staleness1`` round, ``doublebuf`` in one chunk equals ``staleness1``
  bit for bit in precise mode (params, snapshot, metrics), on 8x1 and on
  2x2x2; in four chunks in the fast mode within 2e-5 (dm < 1e-4); the
  kernel route in two chunks within 2e-5.

Then, in this process: a 1x1 mesh equals ``make_round_step`` bit for bit,
and the refusals (tree engine, a misplaced ``staleness_k`` ring)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from benchmarks.common import mlp_init, mlp_loss
from repro.configs import DPPFConfig as JDPPFConfig
from repro.core.engine import ConsensusEngine as JEngine
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import init_train_state as jinit_train_state
from repro.train import make_round_step as jmake_round_step
from repro_torch.benchmarks.common import mlp_loss as tmlp_loss
from repro_torch.configs import DPPFConfig
from repro_torch.core.methods import method_names
from repro_torch.configs.base import MeshPlan
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    init_train_state, make_round_step, make_sharded_round_step,
    shard_train_state, unshard_params,
)

METHODS = method_names(aliases=False)
LEG_METHODS = ("simple_avg", "hard", "easgd", "lsgd", "mgrawa")
FIXED = {"lam_schedule": "fixed"}


def _cases():
    cases = []
    a = dict(mesh="4x2", M=4, tau=2, rounds=2)
    for method in METHODS:
        for mode in ("fast", "precise"):
            cases.append(dict(a, name=f"4x2-{method}-{mode}", method=method,
                              mode=mode))
    for method in ("simple_avg", "easgd"):
        cases.append(dict(a, name=f"4x2-{method}-kernel", method=method,
                          mode="kernel"))
    cases.append(dict(a, name="4x2-staleness1-precise", method="simple_avg",
                      mode="precise", rounds=3,
                      dcfg=dict(FIXED, overlap="staleness1")))
    cases.append(dict(a, name="4x2-doublebuf-precise", method="easgd",
                      mode="precise", rounds=3,
                      dcfg=dict(FIXED, overlap="doublebuf",
                                overlap_chunks=1)))
    for shape in ("8x1", "2x2x2"):
        b = dict(mesh=shape, M=8, tau=4, rounds=3, warm=True)
        for method in LEG_METHODS:
            for mode, chunks in (("precise", 1), ("fast", 4)):
                for ov in ("staleness1", "doublebuf"):
                    d = dict(FIXED, overlap=ov)
                    if ov == "doublebuf":
                        d["overlap_chunks"] = chunks
                    cases.append(dict(
                        b, name=f"{shape}-{method}-{mode}-{ov}",
                        method=method, mode=mode, dcfg=d))
    for ov, extra in (("staleness1", {}), ("doublebuf",
                                           {"overlap_chunks": 2})):
        cases.append(dict(mesh="2x2x2", M=8, tau=4, rounds=3, warm=True,
                          name=f"2x2x2-simple_avg-kernel-{ov}",
                          method="simple_avg", mode="kernel",
                          dcfg=dict(FIXED, overlap=ov, **extra)))
    # one row shard (the doublebuf epilogue over the snapshot, as on one
    # card): 1 x 2 x 4, whose 8-way column group does not divide n = 244,
    # so the columns fall back to fsdp alone and model replicates. The
    # reference's schedule of its sharded leg (lam rising from 0): a fixed
    # lam pushes identical workers apart at round 0, where the fast Gram's
    # floor decides r and the port's single-device round already differs
    # from the reference's by 5.6e-5
    c = dict(mesh="1x2x4", M=4, tau=2, rounds=3, method="easgd")
    for mode in ("fast", "precise", "kernel"):
        for ov, extra in (("none", {}), ("doublebuf", {"overlap_chunks": 2})):
            cases.append(dict(c, name=f"1x2x4-{mode}-{ov}", mode=mode,
                              dcfg=dict(overlap=ov, **extra)))
    return cases


CASES = {c["name"]: c for c in _cases()}
REF_CASES = [n for n, c in CASES.items() if not c.get("warm")]


def _jp0():
    return mlp_init(jax.random.PRNGKey(0), td.DIM, td.NCLS, td.WIDTH)


def _reference(case, jp0):
    """The reference's single-device rounds of a case: the (R, n) view,
    the snapshot and each round's metrics."""
    dkw = td.dcfg_of(case)
    jd = JDPPFConfig(**dkw)
    M = case["M"]
    jstacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (M,) + a.shape), jp0)
    kw = {"fast": dict(use_kernel=False),
          "precise": dict(use_kernel=False, precise=True),
          "kernel": dict(use_kernel=True, interpret=True,
                         block_cols=1 << 16)}[case["mode"]]
    method = jd.consensus if jd.consensus != "ddp" else "simple_avg"
    jeng = JEngine.from_stacked(jstacked, method=method, eps=jd.eps, **kw)
    jopt = jmake_optimizer("sgd", momentum=0.9)
    st = jinit_train_state(lambda k: jp0, jopt, jd, M, jax.random.PRNGKey(0),
                           engine=jeng)
    step = jax.jit(jmake_round_step(mlp_loss, jopt, jd, base_lr=0.05,
                                    total_steps=40))
    metrics = []
    for x, y in td.mlp_batches(case["rounds"] + 1, case["tau"],
                               M)[:case["rounds"]]:
        st, m = step(st, {"x": jnp.asarray(x),
                          "y": jnp.asarray(y, jnp.int32)})
        metrics.append({k: float(m[k]) for k in td.MKEYS}
                       | {"staleness": int(m["staleness"])})
    snap = None if st.snap is None else np.asarray(st.snap["x"])
    return {"params": np.asarray(st.params), "snap": snap,
            "metrics": metrics}


@pytest.fixture(scope="module")
def runs():
    jp0 = _jp0()
    p0 = jax.tree.map(np.asarray, jp0)
    port = td.spawn(td.sharded_cases, 8, p0, list(CASES.values()),
                    ("4x2", "8x1", "2x2x2", "1x2x4"), timeout=400)[0]
    ref = {name: _reference(CASES[name], jp0) for name in REF_CASES}
    return port, ref


def _dp(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _dm(ma, mb, keys=td.MKEYS):
    return max(abs(x[k] - y[k]) for x, y in zip(ma, mb) for k in keys)


BARS = {"fast": (2e-5, 1e-4), "precise": (1e-7, 1e-6),
        "kernel": (2e-5, 1e-4)}


def _within_ulp(a, b):
    """Largest |a - b| in units of eps32 * max(|a|, |b|, 1): one ulp of
    the entry, or of 1 below it."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    return float(np.max(np.abs(a - b) / (np.finfo(np.float32).eps
                                          * scale)))


@pytest.mark.parametrize("mode", ["fast", "precise"])
@pytest.mark.parametrize("method", METHODS)
def test_flat_4x2_every_method_matches_reference(runs, method, mode):
    """Sharded against single-device with the reference's bars, in the
    port; against the reference, the fast bar, and in the precise mode
    one fp32 ulp an entry: the two packages' local steps round apart by
    an ulp (the port's own single-device round shows the same gap), the
    sharded precise round itself adds none."""
    port, ref = runs
    name = f"4x2-{method}-{mode}"
    got, want, single = port[name], ref[name], port[name]["single"]
    bp, bm = BARS[mode]
    dp = _dp(got["params"], single["params"])
    dm = _dm(got["metrics"], single["metrics"])
    assert dp <= bp and dm < bm, (name, "single-device", dp, dm)
    dm = _dm(got["metrics"], want["metrics"])
    if mode == "fast":
        dp = _dp(got["params"], want["params"])
        assert dp < bp and dm < bm, (name, "reference", dp, dm)
    else:
        ulps = _within_ulp(got["params"], want["params"])
        assert ulps <= 1.0 and dm < bm, (name, "reference", ulps, dm)


@pytest.mark.parametrize("method", ["simple_avg", "easgd"])
def test_kernel_route_fused_round_sharded_matches_reference(runs, method):
    port, ref = runs
    name = f"4x2-{method}-kernel"
    for want in (ref[name], port[name]["single"]):
        dp = _dp(port[name]["params"], want["params"])
        dm = _dm(port[name]["metrics"], want["metrics"])
        assert dp < 2e-5 and dm < 1e-4, (name, dp, dm)


@pytest.mark.parametrize("overlap", ["staleness1", "doublebuf"])
def test_overlap_4x2_precise_matches_reference(runs, overlap):
    """Three rounds from the round-0 bubble (staleness1: local steps only;
    doublebuf: an exact consensus), params and snapshot: within 1e-6 of
    the port's single-device round (the reference's bar for its sharded
    staleness1 leg) and of the reference's (staleness1; doublebuf within
    1e-5, the port's cross-package precise bar of
    ``tests/test_torch_overlap.py``: three rounds grow the packages'
    one-ulp local-step gap to 1.3e-6)."""
    port, ref = runs
    name = f"4x2-{overlap}-precise"
    got = port[name]
    for want, bar in ((got["single"], 1e-6),
                      (ref[name], 1e-6 if overlap == "staleness1" else 1e-5)):
        assert _dp(got["params"], want["params"]) < bar, name
        assert _dp(got["snap"], want["snap"]) < bar, name
        assert _dm(got["metrics"], want["metrics"]) < 1e-5, name
        assert [m["staleness"] for m in got["metrics"]] == \
            [m["staleness"] for m in want["metrics"]] == [0, 1, 1]


@pytest.mark.parametrize("method", LEG_METHODS)
@pytest.mark.parametrize("shape", ["8x1", "2x2x2"])
def test_doublebuf_one_chunk_is_staleness1_bit_for_bit(runs, shape,
                                                       method):
    port, _ = runs
    s1 = port[f"{shape}-{method}-precise-staleness1"]
    db = port[f"{shape}-{method}-precise-doublebuf"]
    np.testing.assert_array_equal(db["params"], s1["params"])
    np.testing.assert_array_equal(db["snap"], s1["snap"])
    assert db["metrics"] == s1["metrics"]
    assert [m["staleness"] for m in db["metrics"]] == [1, 1, 1]


@pytest.mark.parametrize("method", LEG_METHODS)
@pytest.mark.parametrize("shape", ["8x1", "2x2x2"])
def test_doublebuf_four_chunks_fast_within_gram_floor(runs, shape, method):
    port, _ = runs
    s1 = port[f"{shape}-{method}-fast-staleness1"]
    db = port[f"{shape}-{method}-fast-doublebuf"]
    dp = _dp(db["params"], s1["params"])
    dm = _dm(db["metrics"], s1["metrics"])
    assert dp < 2e-5 and dm < 1e-4, (shape, method, dp, dm)


def test_doublebuf_kernel_route_hier(runs):
    port, _ = runs
    s1 = port["2x2x2-simple_avg-kernel-staleness1"]
    db = port["2x2x2-simple_avg-kernel-doublebuf"]
    dp = _dp(db["params"], s1["params"])
    assert dp < 2e-5 and _dm(db["metrics"], s1["metrics"]) < 1e-4, dp


@pytest.mark.parametrize("overlap", ["none", "doublebuf"])
@pytest.mark.parametrize("mode", ["fast", "precise", "kernel"])
def test_one_row_shard_with_fallback_columns(runs, mode, overlap):
    """1 x 2 x 4: the column rule falls back to fsdp (2 shards, model
    replicated); the rank holds every worker row. Three rounds against the
    port's single-device round (fast and kernel 2e-5, precise 1e-6) and
    the reference's (fast and kernel 2e-5, precise 1e-5)."""
    port, ref = runs
    name = f"1x2x4-{mode}-{overlap}"
    got = port[name]
    for want, bar in ((got["single"], 1e-6 if mode == "precise" else 2e-5),
                      (ref[name], 1e-5 if mode == "precise" else 2e-5)):
        assert _dp(got["params"], want["params"]) < bar, \
            (name, _dp(got["params"], want["params"]))
        assert _dm(got["metrics"], want["metrics"]) < 1e-4, \
            (name, _dm(got["metrics"], want["metrics"]))
        if overlap == "doublebuf":
            assert _dp(got["snap"], want["snap"]) < bar, name


# ---------------------------------------------------------------------------
# in this process: a world of one, and the refusals
# ---------------------------------------------------------------------------

FLAT_PLAN = MeshPlan(worker_axes=("data",), model_axes=("model",))


@pytest.mark.parametrize("overlap", ["none", "staleness1", "doublebuf"])
def test_1x1_mesh_equals_make_round_step(overlap):
    case = dict(M=4, tau=2, method="easgd",
                dcfg=dict(FIXED, overlap=overlap, overlap_chunks=2))
    p0 = jax.tree.map(np.asarray, _jp0())
    dkw = td.dcfg_of(case)
    st1, opt, dcfg = td._port_state(p0, dkw, 4, "precise")
    st2, _, _ = td._port_state(p0, dkw, 4, "precise")
    mesh = make_cpu_mesh()
    st2 = shard_train_state(st2, mesh, FLAT_PLAN, dcfg=dcfg)
    f1 = make_round_step(tmlp_loss, opt, dcfg, base_lr=0.05, total_steps=40)
    f2 = make_sharded_round_step(tmlp_loss, opt, dcfg, mesh=mesh,
                                 plan=FLAT_PLAN, base_lr=0.05,
                                 total_steps=40)
    for x, y in td.mlp_batches(3, 2, 4):
        b = {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)}
        st1, m1 = f1(st1, b)
        st2, m2 = f2(st2, b)
        assert torch.equal(unshard_params(st2, mesh, FLAT_PLAN), st1.params)
        for k in ("consensus_dist", "pre_dist", "pull_force"):
            assert float(m1[k]) == float(m2[k]), k
        assert m1["staleness"] == m2["staleness"]


def test_refusals():
    p0 = jax.tree.map(np.asarray, _jp0())
    mesh = make_cpu_mesh()
    # the tree engine
    topt = make_optimizer("sgd", momentum=0.9)
    init = lambda gen, device: {l: {k: torch.tensor(v) for k, v in d.items()}
                                for l, d in p0.items()}
    tree = DPPFConfig(engine="tree")
    st = init_train_state(init, topt, tree, 4, None, device="cpu")
    with pytest.raises(ValueError, match="flat"):
        shard_train_state(st, mesh, FLAT_PLAN)
    step = make_sharded_round_step(tmlp_loss, topt, tree, mesh=mesh,
                                   plan=FLAT_PLAN, base_lr=0.05,
                                   total_steps=40)
    x, y = td.mlp_batches(1, 2, 4)[0]
    with pytest.raises(ValueError, match="flat"):
        step(st, {"x": torch.tensor(x), "y": torch.tensor(y)})
    # staleness_k and elastic build and place (tests/
    # test_torch_sharded_staleness_k.py runs them); a ring whose snapshot
    # is not a list of (R, n_local) buffers is refused
    for kw in (dict(overlap="staleness_k", staleness=2),
               dict(overlap="staleness_k", staleness=1, elastic=True)):
        d = DPPFConfig(engine="flat", **kw)
        sk_step = make_sharded_round_step(tmlp_loss, topt, d, mesh=mesh,
                                          plan=FLAT_PLAN, base_lr=0.05,
                                          total_steps=40)
        sk = init_train_state(init, topt, d, 4, None, device="cpu")
        placed = shard_train_state(sk, mesh, FLAT_PLAN)
        assert len(placed.snap["x"]) == kw["staleness"]
        bad_ring = dataclasses.replace(
            placed, snap=dict(placed.snap, x=placed.snap["x"][0]))
        with pytest.raises(ValueError, match="shard_train_state"):
            sk_step(bad_ring, {"x": torch.tensor(x), "y": torch.tensor(y)})
    # a whole state is not a shard
    d = DPPFConfig(engine="flat")
    whole = init_train_state(init, topt, d, 4, None, device="cpu")
    step = make_sharded_round_step(tmlp_loss, topt, d, mesh=mesh,
                                   plan=FLAT_PLAN, base_lr=0.05,
                                   total_steps=40)
    bad = dataclasses.replace(whole, params=whole.params[:, :10])
    with pytest.raises(ValueError, match="shard_train_state"):
        step(bad, {"x": torch.tensor(x), "y": torch.tensor(y)})


# ---------------------------------------------------------------------------
# the launcher on two ranks
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "yi-6b", "--smoke", "--workers", "4", "--tau", "2",
          "--steps", "6", "--seq", "16", "--batch", "2", "--log-every", "1"]


def test_launcher_sharded_matches_unsharded(tmp_path):
    """``--sharded`` (2 x 1: worker rows over the two ranks) and ``--mesh
    1,1,2`` (columns over the two ranks) against the unsharded launcher;
    rank 0 alone prints, with the reference's "sharded round on mesh"
    line. 2 x 1 runs the unsharded run's operations: round metrics
    (--log-every-round) and eval loss bit for bit, but the train loss (a
    mean of the ranks' means, within 1e-6). 1 x 1 x 2 sums its Gram
    over two column shards, and the fast mode's uncentered Gram resolves
    distances to ~5e-4 of themselves (``core/engine.py``'s noise floor;
    5.7e-4 here): the metrics within 1e-3 relative, the eval loss within
    1e-5."""
    import json

    from repro_torch.launch.train import main
    logs = {k: str(tmp_path / f"{k}.jsonl") for k in ("one", "flat", "hier")}
    # the unsharded run in a rank of its own: one torch thread, as the
    # sharded ranks, so that the local steps round alike
    (want, _), = td.spawn(td.launcher_runs, 1,
                          [LAUNCH + ["--log-every-round", logs["one"]]])[0]
    runs = [LAUNCH + ["--sharded", "--log-every-round", logs["flat"]],
            LAUNCH + ["--mesh", "1,1,2", "--log-every-round", logs["hier"]]]
    out = td.spawn(td.launcher_runs, 2, runs)
    rec = lambda k: [json.loads(line) for line in open(logs[k])]
    for i, (kind, shape) in enumerate((("flat", "{'data': 2, 'model': 1}"),
                                       ("hier", "{'data': 1, 'fsdp': 1, "
                                                "'model': 2}"))):
        loss0, text0 = out[0][i]
        loss1, text1 = out[1][i]
        assert loss0 == loss1
        assert loss0 == want if kind == "flat" \
            else abs(loss0 - want) <= 1e-5 * abs(want)
        assert f"sharded round on mesh {shape}" in text0
        assert text1 == ""
        got, ref = rec(kind), rec("one")
        assert len(got) == len(ref) == 3
        for g, w in zip(got, ref):
            for k in ("consensus_dist", "pull_force", "train_loss"):
                if kind == "flat" and k != "train_loss":
                    assert g[k] == w[k], k
                elif kind == "flat":       # a mean of the ranks' means
                    assert g[k] == pytest.approx(w[k], rel=1e-6), k
                else:
                    assert g[k] == pytest.approx(w[k], rel=1e-3), k


@pytest.mark.parametrize("flags, msg", [
    (["--sharded", "--mesh", "1,1,2"], "mutually exclusive"),
    (["--mesh", "2,2"], "three comma-separated ints"),
    (["--sharded", "--engine", "tree"], "--engine flat"),
    (["--sharded", "--method", "ddp"], "communicating"),
    (["--sharded", "--autotune"], "--autotune probes the single-device"),
    (["--mesh", "2,2,2", "--autotune"], "--autotune probes the single-device"),
])
def test_launcher_refuses_bad_sharded_flags(flags, msg, capsys):
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit):
        main(["--smoke", *flags], device="cpu")
    assert msg in capsys.readouterr().err
