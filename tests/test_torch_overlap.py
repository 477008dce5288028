"""The port's overlapped DPPF rounds (staleness1, doublebuf, staleness_k and
elastic staleness_k) against the JAX package on the same numpy inputs, on
the quickstart MLP: fast against fast, precise against precise, and the
port's kernel mode (the wrappers' plain versions on CPU tensors) against
the reference's Pallas kernels in interpret mode. Then the port's own
pins: staleness_k with k = 1 is doublebuf bit for bit, the strided chunk
Grams, the stale epilogue's plain version, ``set_participation``'s
guards, and the launcher's per-round JSONL against the reference
launcher's.

Tolerance: rtol = atol = 1e-4 on parameters and metrics (the one
``tests/test_torch_round.py`` uses); the precise and kernel modes hold
1e-5 (their worst entry is 9.5e-7) and run free over every round. The fast mode's uncentered Gram resolves a
collapsed fleet's distances to ~5e-4 of themselves in either package (the
reference's documented noise floor), and the MLP turns such a difference
into a ReLU that flips in one package and not the other (a 1e-3 jump two
steps later, on staleness_k k = 2 at round 2): each fast round therefore
starts from the reference's carry, so that it compares one round on the
same inputs."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import mlp_init, mlp_loss
from repro.configs import DPPFConfig as JDPPFConfig
from repro.core.engine import ConsensusEngine as JEngine
from repro.kernels.pullpush import pullpush as jpk
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import init_train_state as jinit_train_state
from repro.train import make_round_step as jmake_round_step
from repro.train import set_participation as jset_participation
from repro_torch.configs import DPPFConfig
from repro_torch.core import consensus
from repro_torch.kernels.pullpush import pullpush as pk
from repro_torch.kernels.pullpush import ref
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    init_train_state, make_round_step, set_participation,
)
from repro_torch.train.trainer import _chunk_bounds
from _torch_dist import _one_torch_thread  # noqa: F401 (autouse)


M, TAU, DIM, NCLS, WIDTH = 4, 2, 16, 4, 8
MODES = ("fast", "precise", "kernel")
TOL = {"fast": 1e-4, "precise": 1e-5, "kernel": 1e-5}
OVERLAPS = {
    "staleness1": dict(overlap="staleness1"),
    "doublebuf-c1": dict(overlap="doublebuf", overlap_chunks=1),
    # n = 244 columns in 3 uneven chunks: 82 + 81 + 81
    "doublebuf-c3": dict(overlap="doublebuf", overlap_chunks=3),
    "k1": dict(overlap="staleness_k", staleness=1, overlap_chunks=2),
    "k2": dict(overlap="staleness_k", staleness=2),
    "k3": dict(overlap="staleness_k", staleness=3, overlap_chunks=3),
}


def torch_mlp_loss(params, batch):
    x = batch["x"]
    n = len(params)
    for i in range(n):
        x = x @ params[f"l{i}"]["w"] + params[f"l{i}"]["b"]
        if i < n - 1:
            x = torch.relu(x)
    lse = torch.logsumexp(x, dim=-1)
    picked = torch.gather(x, -1, batch["y"][:, None])[:, 0]
    loss = torch.mean(lse - picked)
    return loss, {"loss": loss}


def _batches(rounds, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((TAU, M, 8, DIM)).astype(np.float32),
             rng.integers(0, NCLS, size=(TAU, M, 8)))
            for _ in range(rounds)]


def _engines(mode, jd, jstacked):
    """The reference engine for a mode, and the port engine's overrides."""
    kw = {"fast": dict(use_kernel=False),
          "precise": dict(use_kernel=False, precise=True),
          "kernel": dict(use_kernel=True, interpret=True,
                         block_cols=1 << 16)}[mode]
    jeng = JEngine.from_stacked(jstacked, method=jd.consensus, eps=jd.eps,
                                **kw)
    return jeng, dict(use_kernel=mode == "kernel", precise=mode == "precise")


def _pair(mode, dkw, lr=0.05, steps=40):
    """The reference's and the port's state and round step from one
    numpy MLP."""
    jd, pd = JDPPFConfig(**dkw), DPPFConfig(**dkw)
    jp0 = mlp_init(jax.random.PRNGKey(0), DIM, NCLS, WIDTH)
    p0 = jax.tree.map(np.asarray, jp0)
    jstacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (M,) + a.shape), jp0)
    jeng, over = _engines(mode, jd, jstacked)
    jopt = jmake_optimizer("sgd", momentum=0.9)
    jstate = jinit_train_state(lambda k: jp0, jopt, jd, M,
                               jax.random.PRNGKey(0), engine=jeng)
    jstep = jax.jit(jmake_round_step(mlp_loss, jopt, jd, base_lr=lr,
                                     total_steps=steps))
    opt = make_optimizer("sgd", momentum=0.9)
    state = init_train_state(
        lambda gen, device: {l: {k: torch.tensor(v) for k, v in d.items()}
                             for l, d in p0.items()},
        opt, pd, M, None, device="cpu")
    state.engine = dataclasses.replace(state.engine, **over)
    step = make_round_step(torch_mlp_loss, opt, pd, base_lr=lr,
                           total_steps=steps)
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(jstate.params))
    return (jstate, jstep), (state, step)


def _run(jstate, jstep, state, step, x, y):
    jstate, jm = jstep(jstate, {"x": jnp.asarray(x),
                                "y": jnp.asarray(y, jnp.int32)})
    state, m = step(state, {"x": torch.tensor(x),
                            "y": torch.tensor(y, dtype=torch.int64)})
    return jstate, jm, state, m


def _sync(state, jstate):
    """The reference's carry (params, momentum, snapshots) into the port's
    state, in place."""
    state.params.copy_(torch.tensor(np.asarray(jstate.params)))
    state.opt["mu"].copy_(torch.tensor(np.asarray(jstate.opt["mu"])))
    snap, jsnap = state.snap, jstate.snap
    xs = snap["x"] if isinstance(snap["x"], list) else [snap["x"]]
    jx = np.asarray(jsnap["x"]).reshape((len(xs),) + tuple(xs[0].shape))
    for x, j in zip(xs, jx):
        x.copy_(torch.tensor(j))
    for k in ("losses", "gns"):
        snap[k] = torch.tensor(np.asarray(jsnap[k]))


def _newest(snap):
    x = snap["x"]
    return x[-1] if isinstance(x, list) else x


def _close(port, want, tol, what):
    np.testing.assert_allclose(np.asarray(port), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(OVERLAPS))
def test_overlap_rounds_match_reference(name, mode):
    """Five rounds of each overlap mode (fill/bubble rounds and stale
    ones; doublebuf in one chunk and in three uneven ones)."""
    dkw = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat",
               lam_schedule="fixed", **OVERLAPS[name])
    (jstate, jstep), (state, step) = _pair(mode, dkw)
    tol = TOL[mode]
    k = dkw.get("staleness", 1)
    for r, (x, y) in enumerate(_batches(5)):
        if mode == "fast":
            _sync(state, jstate)
        jstate, jm, state, m = _run(jstate, jstep, state, step, x, y)
        what = f"{name} {mode} round {r}"
        _close(state.params.numpy(), jstate.params, tol, what)
        jx = jstate.snap["x"]
        _close(_newest(state.snap).numpy(),
               jx[-1] if dkw["overlap"] == "staleness_k" else jx, tol, what)
        for key in ("consensus_dist", "pre_dist", "pull_force",
                    "train_loss"):
            _close(float(m[key]), float(jm[key]), tol, f"{what} {key}")
        assert m["staleness"] == int(jm["staleness"]) \
            == (0 if r < (1 if dkw["overlap"] != "staleness_k" else k)
                else k)


@pytest.mark.parametrize("mode", MODES)
def test_elastic_rounds_match_reference(mode):
    """staleness_k, k = 2, elastic: row 1 dropped through
    ``set_participation`` for rounds 2-4 (the bounded-staleness rule
    forces it back in at round 4, after k misses, with the catch-up pull)
    and round 5 at ``sync = 0``. A frozen row stays bit-exact; the sync = 0
    round leaves every row at its post-step q (the ring's newest slot)."""
    dkw = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat",
               overlap="staleness_k", staleness=2, elastic=True,
               elastic_catchup=0.5, lam_schedule="fixed")
    (jstate, jstep), (state, step) = _pair(mode, dkw)
    tol = TOL[mode]
    for r, (x, y) in enumerate(_batches(6, seed=1)):
        mask = np.ones(M, np.float32)
        if r in (2, 3, 4):
            mask[1] = 0.0
        sync = 0.0 if r == 5 else 1.0
        jstate = jset_participation(jstate, jnp.asarray(mask), sync=sync)
        state = set_participation(state, torch.tensor(mask), sync=sync)
        before = state.params[1].clone()
        jstate, jm, state, m = _run(jstate, jstep, state, step, x, y)
        what = f"elastic {mode} round {r}"
        _close(state.params.numpy(), jstate.params, tol, what)
        _close(float(m["consensus_dist"]), float(jm["consensus_dist"]), tol,
               what)
        missed = state.snap["missed"].tolist()
        assert missed == np.asarray(jstate.snap["missed"]).tolist(), what
        if r in (2, 3):
            assert torch.equal(state.params[1], before), what
            assert missed[1] == r - 1
        if r == 4:                       # forced back in after k misses
            assert not torch.equal(state.params[1], before)
            assert missed[1] == 0
        if r == 5:
            assert torch.equal(state.params, state.snap["x"][-1])


@pytest.mark.parametrize("mode, method", [
    ("precise", "simple_avg"), ("precise", "hard"), ("precise", "easgd"),
    ("precise", "lsgd"), ("precise", "mgrawa"), ("kernel", "simple_avg"),
    ("fast", "easgd"),
])
def test_staleness_k1_bitwise_equals_doublebuf(mode, method):
    """The port's pin of the reference's
    ``test_staleness_k1_bitwise_equals_doublebuf``: k = 1 in one chunk is
    the doublebuf recursion bit for bit (params and snapshot, every
    round), the staleness metric counting depth."""
    base = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat",
                consensus=method, lam_schedule="fixed", overlap_chunks=1)
    runs = []
    for over in (dict(overlap="doublebuf"),
                 dict(overlap="staleness_k", staleness=1)):
        _, (state, step) = _pair(mode, dict(base, **over))
        runs.append([state, step])
    for r, (x, y) in enumerate(_batches(4, seed=2)):
        ms = []
        for run in runs:
            run[0], m = run[1](run[0], {"x": torch.tensor(x), "y": torch.tensor(
                y, dtype=torch.int64)})
            ms.append(m)
        (a, _), (b, _) = runs
        assert torch.equal(a.params, b.params), (mode, method, r)
        assert torch.equal(a.snap["x"], b.snap["x"][0]), (mode, method, r)
        assert ms[0]["staleness"] == ms[1]["staleness"] == (r > 0)


def _flat_state(mode, method="simple_avg"):
    dkw = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat", consensus=method,
               overlap="doublebuf")
    _, (state, _) = _pair(mode, dkw)
    rng = np.random.default_rng(3)
    flat = torch.tensor(rng.standard_normal(
        tuple(state.params.shape)).astype(np.float32) + 2.0)
    return state.engine, DPPFConfig(**dkw), flat


@pytest.mark.parametrize("mode", MODES)
def test_stage_comm_chunks_sum_to_the_one_chunk_forms(mode):
    """Disjoint column chunks of ``stage_comm`` add up to the one-chunk
    contraction's zero-sum forms (the fast mode's plain Gram and the
    precise mode's gap Gram entry for entry)."""
    eng, dcfg, flat = _flat_state(mode)
    T = consensus.lower_stages(eng, dcfg, 0.4)[0][0][1]
    whole = eng.stage_comm(flat, T)
    n = flat.shape[1]
    parts = sum(eng.stage_comm(flat[:, a:b], T)
                for a, b in _chunk_bounds(n, 5))
    R = flat.shape[0]
    V = torch.eye(R) - T
    form = lambda G: torch.sum((V @ G) * V, dim=1)
    np.testing.assert_allclose(form(parts).numpy(), form(whole).numpy(),
                               rtol=1e-5, atol=1e-5)
    if mode != "kernel":
        np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_chunk_bounds_match_reference():
    from repro.train.trainer import _chunk_bounds as jchunk_bounds
    for n, k in ((180, 7), (10, 3), (5, 5), (1_216_385_024, 4)):
        assert _chunk_bounds(n, k) == jchunk_bounds(n, k)


def _stale_inputs(R=4, n=1000, seed=4):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((R, n)).astype(np.float32) * 2 + 1
    q = s + 0.1 * rng.standard_normal((R, n)).astype(np.float32)
    T = np.full((R, R), 1.0 / R, np.float32)
    c0 = np.full((R,), 0.2, np.float32)
    c1 = np.full((R,), -0.4, np.float32)
    return s, q, T, c0, c1


def test_mix_from_gram_and_the_stale_epilogue_match_reference():
    """``mix_from_gram_plain`` against the reference's ``mix_from_gram``
    (Pallas, interpret mode) on the summed chunk Grams, and the stale
    epilogue against the reference's ``q + (c_out - s)``; the plain
    epilogue equals ``q + (mix_shard_plain(s) - s)`` bit for bit."""
    s, q, T, c0, c1 = _stale_inputs()
    bounds = _chunk_bounds(s.shape[1], 3)
    jG = sum(jpk.partial_gram(jnp.asarray(s[:, a:b]), block_cols=1 << 16)
             for a, b in bounds)
    jout, jr, _ = jpk.mix_from_gram(jnp.asarray(s), jnp.asarray(T),
                                    jnp.asarray(c0), jnp.asarray(c1), jG,
                                    block_cols=1 << 16)
    ts, tq = torch.tensor(s), torch.tensor(q)
    G = sum(pk.partial_gram(ts[:, a:b]) for a, b in bounds)
    out, r, _ = pk.mix_from_gram(ts, T, c0, c1, G)
    _close(r.numpy(), jr, 1e-5, "r")
    _close(out.numpy(), jout, 1e-5, "mix_from_gram")
    stale, r2, _ = pk.mix_from_gram(ts, T, c0, c1, G, base=tq)
    _close(stale.numpy(), jnp.asarray(q) + (jout - jnp.asarray(s)), 1e-5,
           "stale epilogue")
    _, coef = ref.gram_coef_plain(G, torch.tensor(T), torch.tensor(c0),
                                  torch.tensor(c1))
    assert torch.equal(stale, tq + (ref.mix_shard_plain(ts, torch.tensor(T),
                                                        coef) - ts))
    # in place over s, as the trainer runs it
    inplace = ts.clone()
    res = pk.stale_mix(inplace, T, coef, tq, out=inplace)
    assert res.data_ptr() == inplace.data_ptr() and torch.equal(res, stale)


def test_strided_chunk_is_read_in_place_and_float4_needs_alignment():
    """``partial_gram`` takes a column slice as it lies (no copy); asked for
    16-byte loads on a chunk whose rows are not 16-byte aligned, it
    refuses before any build."""
    x = torch.randn((4, 1024))
    chunk = x[:, 256:768]
    assert chunk.stride() == (1024, 1)
    assert torch.equal(pk.partial_gram(chunk),
                       ref.partial_gram_plain(chunk.contiguous()))
    assert pk.partial_gram(chunk, vec=4).shape == (4, 4)
    with pytest.raises(ValueError, match="float4"):
        pk.partial_gram(x[:, 1:513], vec=4)
    with pytest.raises(ValueError, match="float4"):
        pk.partial_gram(torch.randn((4, 1023))[:, :512], vec=4)
    with pytest.raises(ValueError, match="unit column stride"):
        pk.partial_gram(x[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        pk.mix_shard(chunk, torch.full((4, 4), 0.25), torch.zeros(4))


def test_set_participation_validates():
    """As ``tests/test_staleness_k.py::test_set_participation_validates``:
    a non-elastic state refuses, a wrong mask shape refuses."""
    opt = make_optimizer("sgd", momentum=0.9)
    p0 = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0), DIM, NCLS,
                                           WIDTH))
    init = lambda gen, device: {l: {k: torch.tensor(v) for k, v in d.items()}
                                for l, d in p0.items()}
    st = init_train_state(init, opt, DPPFConfig(
        engine="flat", overlap="staleness_k", staleness=2), M, None,
        device="cpu")
    with pytest.raises(ValueError, match="elastic"):
        set_participation(st, torch.ones(M))
    st_e = init_train_state(init, opt, DPPFConfig(
        engine="flat", overlap="staleness_k", staleness=2, elastic=True), M,
        None, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        set_participation(st_e, torch.ones(M + 1))
    out = set_participation(st_e, torch.zeros(M), sync=0.0)
    assert torch.equal(out.snap["active"], torch.zeros(M))
    assert float(out.snap["sync"]) == 0.0
    assert len(st_e.snap["x"]) == 2 and st_e.snap["missed"].dtype \
        == torch.int32
    with pytest.raises(ValueError, match="engine='flat'"):
        DPPFConfig(engine="tree", overlap="doublebuf")


def test_launcher_round_log_matches_reference(tmp_path):
    """``--overlap doublebuf --log-every-round`` on the CPU: one record a
    round with the reference launcher's keys, clock position and
    staleness (0 in round 0, 1 after); the losses differ only through the
    two packages' random initial weights."""
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main
    flags = ["--arch", "yi-6b", "--smoke", "--d-model", "32", "--layers",
             "1", "--workers", "4", "--tau", "2", "--steps", "6", "--seq",
             "16", "--batch", "2", "--overlap", "doublebuf",
             "--overlap-chunks", "3"]
    loss = main(flags + ["--log-every-round", str(tmp_path / "port.jsonl")],
                device="cpu")
    jloss = jmain(flags + ["--log-every-round", str(tmp_path / "ref.jsonl")])
    assert np.isfinite(loss) and np.isfinite(jloss)
    read = lambda p: [json.loads(line) for line in open(p)]
    port, want = read(tmp_path / "port.jsonl"), read(tmp_path / "ref.jsonl")
    assert len(port) == len(want) == 3
    for a, b in zip(port, want):
        assert set(a) == set(b)
        assert {k: a[k] for k in ("round", "start", "tau", "staleness")} \
            == {k: b[k] for k in ("round", "start", "tau", "staleness")}
        assert a["lam_t"] == pytest.approx(b["lam_t"], abs=1e-6)
        assert all(np.isfinite(v) for v in a.values())
    assert [r["staleness"] for r in port] == [0.0, 1.0, 1.0]
