"""The port's sharded ``staleness_k`` and elastic rounds
(``make_sharded_round_step`` on gloo ranks, ``tests/_torch_dist.py``) and
``launch.mesh.ring_gather``, on the quickstart MLP (dim 16, 4 classes,
width 8), the pins of the reference's ``tests/test_staleness_k.py:363-500``:

* ``ring_gather`` equals ``all_gather`` bit for bit, in its order (blocks
  of 1 and 3 rows, dims 0 and 1, blocking and asynchronous), on 8x1 and
  on 2x2x2's worker axis; a multi-axis group falls back to the gather; a
  group of one is the identity;
* sharded k = 1 in one chunk equals sharded ``doublebuf`` in one chunk
  bit for bit (params, snapshot, metrics), five methods, precise mode,
  on 8x1 (where the chunk gathers run the ring) and on 2x2x2;
* k = 2 and elastic k = 2 (a row out in rounds 1-2, forced back in with
  its catch-up at round 3, ``sync = 0`` in round 4), 5 rounds, against
  the port's single-device round on 8x1, 2x2x2 and 4x2, with the bars
  of ``tests/test_torch_sharded_round.py``: parameters and every ring slot within 1e-7 (precise) and 2e-5
  (fast) of the parameter scale, metrics within 1e-6 / 1e-4. Seen: 0 on
  the meshes that split no column; 6.9e-8 precise and 1.4e-6 fast where
  the Gram is summed over column shards;
* the elastic runs against the reference's single-device rounds on the
  same numpy inputs: within 1e-6 (precise; one fp32 ulp of the local
  steps grows to 1.8e-7) and 2e-5 (fast; 9.5e-7 seen);
* a checkpoint written on 2x2x2 resumes on 8x1, whose checkpoint resumes
  unsharded: equal to six single-device rounds within 1e-7 of the scale
  (precise);
* each rank's block reads of a file (``load_train_state`` with ``mesh``)
  equal ``shard_train_state`` of the whole loaded state bit for bit, on
  8x1, 2x2x2 and 4x2, for ring files (k = 2, 1), an exact-mode one and
  one without the quorum gate;
* a fault inside one rank's local steps of a stale round fails the round
  on every rank under the supervisor, which restores and replays alike
  on all of them."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as td
from benchmarks.common import mlp_init, mlp_loss
from repro.configs import DPPFConfig as JDPPFConfig
from repro.core.engine import ConsensusEngine as JEngine
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import init_train_state as jinit_train_state
from repro.train import make_round_step as jmake_round_step
from repro.train import set_participation as jset_participation

FIXED = {"lam_schedule": "fixed"}
METHODS = ("simple_avg", "hard", "easgd", "lsgd", "mgrawa")
# the default (increasing) lam: a fixed lam pushes the identical initial
# workers apart at round 0, where the fast Gram's noise floor decides r
# (``tests/test_torch_sharded_round.py``'s 1x2x4 leg says the same)
K2 = dict(overlap="staleness_k", staleness=2, overlap_chunks=2)
ELASTIC = dict(K2, elastic=True, elastic_catchup=0.5)
SHAPES = {"8x1": (8, 4), "2x2x2": (8, 4), "4x2": (4, 2)}
# parameter bars, of the scale, against the port's single-device round
BARS = {"precise": 1e-7, "fast": 2e-5}
METRIC_BARS = {"precise": 1e-6, "fast": 1e-4}
REF_BARS = {"precise": 1e-6, "fast": 2e-5}


def _cases():
    cases = []
    for shape in ("8x1", "2x2x2"):
        for method in METHODS:
            for ov, d in (("doublebuf", dict(FIXED, overlap="doublebuf",
                                             overlap_chunks=1)),
                          ("k1", dict(FIXED, overlap="staleness_k",
                                      staleness=1, overlap_chunks=1))):
                cases.append(dict(name=f"{shape}-{method}-{ov}", mesh=shape,
                                  M=8, tau=4, rounds=4, method=method,
                                  mode="precise", dcfg=d, single=False))
    for shape, (M, tau) in SHAPES.items():
        for mode in ("precise", "fast"):
            base = dict(mesh=shape, M=M, tau=tau, rounds=5, mode=mode)
            cases.append(dict(base, name=f"{shape}-k2-{mode}",
                              method="simple_avg", dcfg=K2))
            cases.append(dict(base, name=f"{shape}-elastic-{mode}",
                              method="easgd", dcfg=ELASTIC,
                              drop=(1, [1, 2]), sync0=[4]))
    return cases


CASES = {c["name"]: c for c in _cases()}
RESUME = dict(M=8, tau=4, method="easgd", mode="precise", dcfg=ELASTIC,
              drop=(1, [1, 2]))


def _p0():
    return jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0), td.DIM,
                                             td.NCLS, td.WIDTH))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    p0 = _p0()
    ring = td.spawn(td.ring_checks, 8)[0]
    cases = td.spawn(td.staleness_k_cases, 8, p0, list(CASES.values()),
                     tuple(SHAPES), timeout=400)[0]
    tmp = str(tmp_path_factory.mktemp("resume"))
    resume = td.spawn(td.cross_mesh_resume, 8, p0, RESUME, tmp)[0]
    return ring, cases, resume


def _dp(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _dm(ma, mb):
    return max(abs(x[k] - y[k]) for x, y in zip(ma, mb) for k in td.MKEYS)


def test_ring_gather_matches_all_gather(runs):
    ring, _, _ = runs
    assert len(ring) == 18
    bad = [k for k, ok in ring.items() if not ok]
    assert not bad, bad


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", ["8x1", "2x2x2"])
def test_sharded_k1_is_doublebuf_bit_for_bit(runs, shape, method):
    _, cases, _ = runs
    db = cases[f"{shape}-{method}-doublebuf"]
    k1 = cases[f"{shape}-{method}-k1"]
    np.testing.assert_array_equal(k1["params"], db["params"])
    assert len(k1["snap"]) == len(db["snap"]) == 1
    np.testing.assert_array_equal(k1["snap"][0], db["snap"][0])
    assert k1["metrics"] == db["metrics"]
    assert [m["staleness"] for m in k1["metrics"]] == [0, 1, 1, 1]


@pytest.mark.parametrize("mode", ["precise", "fast"])
@pytest.mark.parametrize("kind", ["k2", "elastic"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sharded_ring_matches_single_device(runs, shape, kind, mode):
    """k = 2 and elastic k = 2 on the mesh against the port's single-device
    rounds: params and every ring slot within the mode's bar of the
    scale, metrics within its metric bar, staleness 0 0 2 2 2."""
    _, cases, _ = runs
    got = cases[f"{shape}-{kind}-{mode}"]
    want = got["single"]
    scale = float(np.max(np.abs(want["params"])))
    bar = BARS[mode] * scale
    assert _dp(got["params"], want["params"]) <= bar, \
        (_dp(got["params"], want["params"]) / scale)
    assert len(got["snap"]) == len(want["snap"]) == 2
    for g, w in zip(got["snap"], want["snap"]):
        assert _dp(g, w) <= bar
    assert _dm(got["metrics"], want["metrics"]) <= METRIC_BARS[mode]
    assert [m["staleness"] for m in got["metrics"]] == [0, 0, 2, 2, 2]


def _reference_rounds(case):
    """The reference's single-device rounds of a case (set_participation
    with the case's mask and quorum gate before each)."""
    dkw = td.dcfg_of(case)
    jd = JDPPFConfig(**dkw)
    M = case["M"]
    jp0 = mlp_init(jax.random.PRNGKey(0), td.DIM, td.NCLS, td.WIDTH)
    jstacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (M,) + a.shape), jp0)
    kw = {"fast": dict(use_kernel=False),
          "precise": dict(use_kernel=False, precise=True)}[case["mode"]]
    jeng = JEngine.from_stacked(jstacked, method=jd.consensus, eps=jd.eps,
                                **kw)
    jopt = jmake_optimizer("sgd", momentum=0.9)
    st = jinit_train_state(lambda k: jp0, jopt, jd, M, jax.random.PRNGKey(0),
                           engine=jeng)
    step = jax.jit(jmake_round_step(mlp_loss, jopt, jd, base_lr=0.05,
                                    total_steps=40))
    for r, (x, y) in enumerate(td.mlp_batches(case["rounds"], case["tau"],
                                              M)):
        mask, sync = td._mask_of(case, r, M)
        st = jset_participation(st, jnp.asarray(mask), sync=sync)
        st, _ = step(st, {"x": jnp.asarray(x),
                          "y": jnp.asarray(y, jnp.int32)})
    return np.asarray(st.params), np.asarray(st.snap["x"])


@pytest.mark.parametrize("mode", ["precise", "fast"])
@pytest.mark.parametrize("shape", ["8x1", "2x2x2"])
def test_sharded_elastic_matches_reference(runs, shape, mode):
    _, cases, _ = runs
    case = CASES[f"{shape}-elastic-{mode}"]
    got = cases[case["name"]]
    params, ring = _reference_rounds(case)
    assert _dp(got["params"], params) < REF_BARS[mode]
    for slot, want in zip(got["snap"], ring):
        assert _dp(slot, want) < REF_BARS[mode]


def test_cross_mesh_resume_2x2x2_to_8x1_to_unsharded(runs):
    _, _, res = runs
    assert res["rounds"] == [2, 4]
    assert res["round"] == 6 and res["t"] == 6 * RESUME["tau"]
    scale = float(np.max(np.abs(res["straight"])))
    assert _dp(res["resumed"], res["straight"]) <= 1e-7 * scale
    for g, w in zip(res["snap"], res["snap_straight"]):
        assert _dp(g, w) <= 1e-7 * scale


LOAD_CASE = dict(M=8, tau=4, method="easgd", mode="precise", dcfg=ELASTIC,
                 drop=(1, [1]), sync0=[2])
FAULT_CASE = dict(M=4, tau=4, method="simple_avg", mode="fast",
                  dcfg=dict(overlap="staleness_k", staleness=1,
                            overlap_chunks=2))


@pytest.fixture(scope="module")
def loads(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("loads"))
    return td.spawn(td.sharded_load_checks, 8, _p0(), LOAD_CASE, tmp)[0]


@pytest.mark.parametrize("how", ["in_place", "template"])
@pytest.mark.parametrize("kind", ["ring", "ring1", "exact", "legacy"])
@pytest.mark.parametrize("shape", ["8x1", "2x2x2", "4x2"])
def test_sharded_load_reads_each_ranks_blocks(loads, shape, kind, how):
    """Each rank's block reads (``load_train_state`` with ``mesh``) equal
    ``shard_train_state`` of the whole loaded state bit for bit: elastic
    k = 2 and k = 1 files (the ring, the elastic carry, the momentum), an
    exact-mode file (the snapless warm start: every slot takes the view)
    and a file without ``snap::sync`` (backfilled at 1); into the shard
    in place and into ``state_template`` of it."""
    assert len(loads) == 24
    assert loads[f"{shape}-{kind}-{how}"]


@pytest.mark.parametrize("kind", ["error", "oom"])
def test_fault_in_one_ranks_local_steps_fails_the_round_on_all(tmp_path,
                                                             kind):
    """Rank 1 of four (2x2) raises inside its local steps of a stale
    sharded staleness_k round, after the round's first chunk gather went
    out: every rank fails the round (none waits in a collective), the
    supervisors restore and replay alike, an error's replay equals the
    run without the fault bit for bit, and an OOM halves the batch on
    every rank."""
    res = td.spawn(td.local_step_fault, 4, _p0(), FAULT_CASE, str(tmp_path),
                   kind, timeout=240)
    straight = res[0]["straight"]
    assert straight["event_seq"] == []
    for r in res:
        assert r["fault"]["event_seq"] == res[0]["fault"]["event_seq"]
    seq = res[0]["fault"]["event_seq"]
    if kind == "error":
        assert seq == ["r2:restore", "r2:retry"]
        assert res[0]["fault"]["final_batch"] == 8
        np.testing.assert_array_equal(res[0]["fault"]["params"],
                                      straight["params"])
    else:
        assert seq == ["r2:oom", "r2:shrink", "r2:restore", "r2:retry"]
        assert {r["fault"]["final_batch"] for r in res} == {4}
    assert np.all(np.isfinite(res[0]["fault"]["params"]))


def test_sharded_state_places_the_ring():
    """``shard_train_state`` keeps each ring slot's columns and the elastic
    carry whole, on a world of one (the 1x1 mesh)."""
    import torch
    from repro_torch.configs.base import MeshPlan
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.train import shard_train_state
    st, _, dcfg = td._port_state(_p0(), td.dcfg_of(dict(
        M=4, tau=2, method="simple_avg", dcfg=ELASTIC)), 4, "fast")
    sst = shard_train_state(st, make_cpu_mesh(), MeshPlan(
        worker_axes=("data",), model_axes=("model",)), dcfg=dcfg)
    assert isinstance(sst.snap["x"], list) and len(sst.snap["x"]) == 2
    for a, b in zip(sst.snap["x"], st.snap["x"]):
        assert torch.equal(a, b)
    assert set(sst.snap) == {"x", "losses", "gns", "act", "active",
                             "missed", "sync"}
    assert dataclasses.is_dataclass(sst)
