"""The port's fault-tolerant round supervisor (``repro_torch.train.
supervisor``) and chaos plans (``train.chaos``) against the JAX package's,
every case of the reference's ``tests/test_supervisor.py`` (its checkpoint
cases are in ``tests/test_torch_checkpoint.py``): the byte-stable
``ChaosPlan`` (one file loads in both packages), the heartbeat state
machine, quorum degrade through the ``sync`` gate, the rotation
checkpoints with the corrupt-archive restore ladder, the OOM shrink and
replay, the retry budget; the OOM contract (``is_oom``) on PyTorch's own
allocator error. The supervised MLP runs (elastic staleness_k, k = 2,
precise mode) are held against the reference's supervisor on the same
numpy batches: the same event sequence, counters, backoffs and final
batch, and the parameters within 1e-5 (the cross-package precise bar of
``tests/test_torch_overlap.py``: the packages' local steps round apart by
an ulp a round; 6.5 ulps seen after six rounds).

The reference's slow 8-device chaos leg is tier-1 here: the port's
launcher on 8 gloo ranks replays ``results/chaos/plan_ci.json`` to
exactly the ``event_seq``, ``counters`` and ``final_batch`` of
``results/chaos/events_ci.json`` (the pinned command: reduced yi-6b at
d_model 32, 1 layer, ``--sharded`` staleness_k k = 2, quorum 7). And the
launcher's ``--elastic-drop`` / ``--quorum`` events line equals the
reference launcher's for the same flags."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os

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
from repro.train import ChaosMembership as JChaosMembership
from repro.train import ChaosPlan as JChaosPlan
from repro.train import FaultInjector as JFaultInjector
from repro.train import RoundClock as JRoundClock
from repro.train import Supervisor as JSupervisor
from repro.train import init_train_state as jinit_train_state
from repro.train import make_round_step as jmake_round_step
from repro_torch.benchmarks.common import mlp_loss as tmlp_loss
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import DPPFConfig
from repro_torch.train import (
    ChaosEvent, ChaosMembership, ChaosPlan, FaultInjector,
    HeartbeatMembership, InjectedOOM, RoundClock, ScheduleMembership,
    Supervisor, is_oom, make_round_step, set_participation,
)
from repro_torch.train.supervisor import ACTIVE, DEAD, REJOINING, SUSPECT

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
M, TAU, K = 4, 2, 2
DKW = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat", consensus="easgd",
           overlap="staleness_k", staleness=K, elastic=True,
           lam_schedule="fixed")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _p0():
    return jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0), td.DIM,
                                             td.NCLS, td.WIDTH))


def _numpy_batch(spec, bs):
    rng = np.random.default_rng(1000 + spec.index)
    return (rng.standard_normal((spec.tau, M, bs, td.DIM)).astype(np.float32),
            rng.integers(0, td.NCLS, size=(spec.tau, M, bs)))


def _setup(steps=12, elastic=True):
    dkw = dict(DKW, elastic=elastic)
    st, opt, dcfg = td._port_state(_p0(), dkw, M, "precise")
    clock = RoundClock.from_config(dcfg, base_lr=0.05, total_steps=steps)
    step = make_round_step(tmlp_loss, opt, dcfg, clock=clock)

    def batch_fn(spec, bs):
        x, y = _numpy_batch(spec, bs)
        return {"x": torch.tensor(x), "y": torch.tensor(y,
                                                         dtype=torch.int64)}
    return dcfg, clock, step, st, batch_fn


def _jsetup(steps=12):
    jd = JDPPFConfig(**DKW)
    jp0 = mlp_init(jax.random.PRNGKey(0), td.DIM, td.NCLS, td.WIDTH)
    jstacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (M,) + a.shape), jp0)
    jeng = JEngine.from_stacked(jstacked, method=jd.consensus, eps=jd.eps,
                                use_kernel=False, precise=True)
    jopt = jmake_optimizer("sgd", momentum=0.9)
    st = jinit_train_state(lambda k: jp0, jopt, jd, M, jax.random.PRNGKey(0),
                           engine=jeng)
    clock = JRoundClock.from_config(jd, base_lr=0.05, total_steps=steps)
    step = jax.jit(jmake_round_step(mlp_loss, jopt, jd, clock=clock))

    def batch_fn(spec, bs):
        x, y = _numpy_batch(spec, bs)
        return {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)}
    return clock, step, st, batch_fn


def _params(state):
    return state.params.numpy().copy()


# ---------------------------------------------------------------------------
# ChaosPlan: the byte-stable fault script
# ---------------------------------------------------------------------------

def test_chaos_plan_roundtrip_bytes(tmp_path):
    a = ChaosPlan(events=(
        ChaosEvent(round=5, kind="oom", batch_above=2),
        ChaosEvent(round=1, kind="kill", worker=3, duration=2),
        ChaosEvent(round=1, kind="corrupt_ckpt"),
    ), seed=3)
    b = ChaosPlan(events=tuple(reversed(a.events)), seed=3)
    assert a.dumps() == b.dumps()
    path = str(tmp_path / "plan.json")
    a.save(path)
    assert ChaosPlan.load(path).dumps() == a.dumps()
    with open(path) as f:
        assert f.read() == a.dumps()
    assert a.is_down(3, 1) and a.is_down(3, 2) and not a.is_down(3, 3)
    assert not a.is_down(0, 1)
    assert len(a.membership_events()) == 1
    # the same bytes in both packages, and the committed CI plan loads in
    # both to the same bytes
    assert JChaosPlan.load(path).dumps() == a.dumps()
    ci = os.path.join(ROOT, "results", "chaos", "plan_ci.json")
    with open(ci) as f:
        raw = f.read()
    assert ChaosPlan.load(ci).dumps() == JChaosPlan.load(ci).dumps() == raw


def test_chaos_plan_validation():
    with pytest.raises(ValueError, match="unknown chaos kind"):
        ChaosEvent(round=0, kind="meteor")
    with pytest.raises(ValueError, match="round"):
        ChaosEvent(round=-1, kind="corrupt_ckpt")
    with pytest.raises(ValueError, match="duration"):
        ChaosEvent(round=0, kind="kill", worker=0, duration=0)
    with pytest.raises(ValueError, match="worker"):
        ChaosEvent(round=0, kind="netdrop")
    with pytest.raises(ValueError, match="batch_above"):
        ChaosEvent(round=0, kind="oom")
    with pytest.raises(ValueError, match="version"):
        ChaosPlan(version=99)
    with pytest.raises(ValueError, match="malformed ChaosPlan"):
        ChaosPlan.from_dict({"seed": 0})
    with pytest.raises(ValueError, match="malformed ChaosPlan"):
        ChaosPlan.from_dict({"events": [{"kind": "oom"}]})
    assert is_oom(InjectedOOM(8))
    assert is_oom(InjectedOOM(8, round_idx=3))
    assert "round 3" in str(InjectedOOM(8, round_idx=3))
    assert str(InjectedOOM(8, round_idx=3)).startswith("RESOURCE_EXHAUSTED")


def test_is_oom_matches_the_cuda_allocator_error():
    """PyTorch's own OOM (``torch.cuda.OutOfMemoryError("CUDA out of
    memory. ...")``) matches the contract; other faults do not."""
    err = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)")
    assert is_oom(err)
    assert is_oom(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    assert not is_oom(RuntimeError("CUDA error: an illegal memory access"))
    assert not is_oom(ValueError("shape mismatch"))


def test_fault_injector_hooks(tmp_path):
    plan = ChaosPlan(events=(
        ChaosEvent(round=2, kind="oom", batch_above=2),
        ChaosEvent(round=1, kind="corrupt_ckpt"),
    ))
    inj = FaultInjector(plan)
    inj.before_step(1, 8)
    inj.before_step(2, 2)
    with pytest.raises(InjectedOOM):
        inj.before_step(2, 4)
    path = str(tmp_path / "c.npz")
    save_pytree(path, {"w": torch.arange(64.0)})
    assert not inj.after_save(0, path)
    load_pytree(path, {"w": torch.zeros(64)})
    assert inj.after_save(1, path)            # torn to half its bytes
    with pytest.raises(ValueError, match="corrupt"):
        load_pytree(path, {"w": torch.zeros(64)})


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

def test_heartbeat_state_machine():
    hb = HeartbeatMembership(3, timeout=0.9, suspect_after=1, dead_after=2)
    mask, tr = hb.poll(0.0)
    np.testing.assert_array_equal(mask, [1, 1, 1])
    assert tr == []
    hb.beat(0, 1.0), hb.beat(1, 1.0)
    mask, tr = hb.poll(1.0)
    assert tr == [(2, ACTIVE, SUSPECT)]
    np.testing.assert_array_equal(mask, [1, 1, 0])
    hb.beat(0, 2.0), hb.beat(1, 2.0)
    mask, tr = hb.poll(2.0)
    assert tr == [(2, SUSPECT, DEAD)]
    assert hb.beat(2, 3.0) == [(2, DEAD, REJOINING)]
    mask, _ = hb.poll(3.0)
    np.testing.assert_array_equal(mask, [0, 0, 1])
    assert hb.beat(2, 4.0) == [(2, REJOINING, ACTIVE)]
    assert hb.beat(0, 4.0) == [(0, SUSPECT, ACTIVE)]
    with pytest.raises(ValueError, match="out of range"):
        hb.beat(3, 0.0)
    with pytest.raises(ValueError, match="timeout"):
        HeartbeatMembership(2, timeout=0.0)
    with pytest.raises(ValueError, match="suspect_after"):
        HeartbeatMembership(2, timeout=1.0, suspect_after=3, dead_after=2)


def test_chaos_membership_windows_and_monotonic_advance():
    plan = ChaosPlan(events=(
        ChaosEvent(round=1, kind="kill", worker=1, duration=2),))
    cm = ChaosMembership(plan, 2, timeout=0.9)
    jcm = JChaosMembership(JChaosPlan.from_dict(plan.to_dict()), 2,
                           timeout=0.9)
    mask, ev = cm.mask_for(0)
    np.testing.assert_array_equal(mask, [1, 1])
    assert ev == []
    mask, ev = cm.mask_for(1)
    np.testing.assert_array_equal(mask, [1, 0])
    assert ev == [{"event": "suspect", "worker": 1, "from": ACTIVE}]
    with pytest.raises(ValueError, match="one round at a time"):
        cm.mask_for(1)
    _, ev = cm.mask_for(2)
    assert [e["event"] for e in ev] == ["evict"]
    _, ev = cm.mask_for(3)
    assert [e["event"] for e in ev] == ["rejoin"]
    _, ev = cm.mask_for(4)
    assert [e["event"] for e in ev] == ["recover"]
    with pytest.raises(ValueError, match="round_s"):
        ChaosMembership(plan, 2, timeout=0.9, round_s=0.0)
    # the reference's table walks the same transitions
    cm2 = ChaosMembership(plan, 2, timeout=0.9)
    for r in range(6):
        (m1, e1), (m2, e2) = cm2.mask_for(r), jcm.mask_for(r)
        np.testing.assert_array_equal(m1, m2)
        assert e1 == e2


def test_schedule_membership_validation():
    with pytest.raises(ValueError, match="out of range"):
        ScheduleMembership(4, [(7, 0, 2)])
    with pytest.raises(ValueError, match="empty or negative"):
        ScheduleMembership(4, [(1, 3, 3)])
    sm = ScheduleMembership(4, [(1, 1, 3)])
    np.testing.assert_array_equal(sm.mask_for(0)[0], [1, 1, 1, 1])
    np.testing.assert_array_equal(sm.mask_for(2)[0], [1, 0, 1, 1])


# ---------------------------------------------------------------------------
# the sync gate
# ---------------------------------------------------------------------------

def test_sync_gate_value_identity_and_degrade():
    _, clock, step, st0, batch_fn = _setup()
    assert float(st0.snap["sync"]) == 1.0
    mask = np.ones((M,), np.float32)
    a = set_participation(st0, mask)
    b = set_participation(st0, mask, sync=1.0)
    for k in a.snap:
        if k != "x":
            assert torch.equal(a.snap[k], b.snap[k]), k
    _, _, step_b, st_b, _ = _setup()
    on = set_participation(st0, mask, sync=1.0)
    off = set_participation(st_b, mask, sync=0.0)
    for spec in clock.rounds[:2]:
        on, _ = step(on, batch_fn(spec, 8))
        off, _ = step_b(off, batch_fn(spec, 8))
    assert np.abs(_params(on) - _params(off)).max() > 0.0
    assert float(off.snap["sync"]) == 0.0
    assert np.isfinite(_params(off)).all()
    off = set_participation(off, mask, sync=1.0)
    off, _ = step_b(off, batch_fn(clock.rounds[2], 8))
    assert np.isfinite(_params(off)).all()


def test_sync_gate_requires_elastic_carry():
    _, _, _, st, _ = _setup(elastic=False)
    with pytest.raises(ValueError, match="elastic"):
        set_participation(st, np.ones((M,)), sync=0.0)
    _, _, _, st_e, _ = _setup()
    legacy = dataclasses.replace(
        st_e, snap={k: v for k, v in st_e.snap.items() if k != "sync"})
    with pytest.raises(ValueError, match="sync"):
        set_participation(legacy, np.ones((M,)), sync=0.0)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def test_supervisor_empty_plan_is_plain_loop():
    _, clock, step, st_a, batch_fn = _setup()
    for spec in clock.rounds:
        st_a, _ = step(st_a, batch_fn(spec, 8))
    _, _, step2, st_b, _ = _setup()
    sup = Supervisor(clock, workers=M, batch_size=8)
    st_b = sup.run(st_b, step2, batch_fn)
    np.testing.assert_array_equal(_params(st_a), _params(st_b))
    assert sup.events == [] and sup.summary()["counters"] == {}


def test_supervisor_schedule_membership_parity():
    drop = (1, 1, 3)
    _, clock, step, st_a, batch_fn = _setup()
    for spec in clock.rounds:
        mask = np.ones(M, np.float32)
        if drop[1] <= spec.index < drop[2]:
            mask[drop[0]] = 0.0
        st_a = set_participation(st_a, mask)
        st_a, _ = step(st_a, batch_fn(spec, 8))
    _, _, step2, st_b, _ = _setup()
    sup = Supervisor(clock, workers=M,
                     membership=ScheduleMembership(M, [drop]), batch_size=8)
    st_b = sup.run(st_b, step2, batch_fn)
    np.testing.assert_array_equal(_params(st_a), _params(st_b))
    assert sup.events == []


def _chaos_run(tmp_path, plan, tag, *, quorum=M, logger=None,
               retry_budget=3, batch=8):
    _, clock, step, state, batch_fn = _setup()
    sup = Supervisor(clock, workers=M,
                     membership=ChaosMembership(plan, M, timeout=0.9),
                     quorum=quorum, chaos=FaultInjector(plan),
                     ckpt_dir=str(tmp_path / tag), batch_size=batch,
                     logger=logger, retry_budget=retry_budget,
                     seed=plan.seed)
    return sup, sup.run(state, step, batch_fn)


def _reference_run(tmp_path, plan, tag, *, quorum=M):
    clock, step, state, batch_fn = _jsetup()
    jplan = JChaosPlan.from_dict(plan.to_dict())
    sup = JSupervisor(clock, workers=M,
                      membership=JChaosMembership(jplan, M, timeout=0.9),
                      quorum=quorum, chaos=JFaultInjector(jplan),
                      ckpt_dir=str(tmp_path / tag), batch_size=8,
                      seed=plan.seed)
    return sup, sup.run(state, step, batch_fn)


def _same_as_reference(sup, state, jsup, jstate):
    assert sup.summary() == jsup.summary()
    assert [(e["round"], e["event"], e.get("backoff_s"), e.get("attempt"))
            for e in sup.events] == \
        [(e["round"], e["event"], e.get("backoff_s"), e.get("attempt"))
         for e in jsup.events]
    assert np.max(np.abs(_params(state) - np.asarray(jstate.params))) \
        < 1e-5


def test_supervisor_oom_shrink_restore_replay(tmp_path):
    plan = ChaosPlan(events=(
        ChaosEvent(round=2, kind="oom", batch_above=4),), seed=5)
    sup, state = _chaos_run(tmp_path, plan, "a")
    assert sup.summary()["counters"] == {
        "ckpt_saved": 7, "oom": 1, "restore": 1, "retry": 1, "shrink": 1}
    assert sup.batch_size == 4
    seq = sup.event_seq()
    assert seq[:2] == ["r2:oom", "r2:shrink"]
    assert "r2:restore" in seq and "r2:retry" in seq
    sup2, state2 = _chaos_run(tmp_path, plan, "b")
    assert sup2.event_seq() == seq
    np.testing.assert_array_equal(_params(state), _params(state2))
    rows = []
    _chaos_run(tmp_path, plan, "c",
               logger=lambda spec, m: rows.append((spec, dict(m))))
    assert [m["event"] for _, m in rows if "event" in m] == \
        ["oom", "shrink", "restore", "retry"]
    _same_as_reference(sup, state, *_reference_run(tmp_path, plan, "j"))


def test_supervisor_corrupt_ckpt_ladder(tmp_path):
    plan = ChaosPlan(events=(
        ChaosEvent(round=1, kind="corrupt_ckpt"),
        ChaosEvent(round=2, kind="oom", batch_above=4),), seed=5)
    sup, state = _chaos_run(tmp_path, plan, "a")
    c = sup.summary()["counters"]
    assert c["restore_corrupt"] == 1 and c["restore"] == 1
    seq = sup.event_seq()
    assert seq.index("r2:restore_corrupt") < seq.index("r2:restore")
    assert any(e["event"] == "restore" and "round 1" in e["detail"]
               for e in sup.events)
    assert np.isfinite(_params(state)).all()
    _same_as_reference(sup, state, *_reference_run(tmp_path, plan, "j"))


def test_supervisor_quorum_degrade_backoff(tmp_path):
    plan = ChaosPlan(events=(
        ChaosEvent(round=1, kind="kill", worker=0, duration=1),
        ChaosEvent(round=1, kind="netdrop", worker=2, duration=1),), seed=9)
    sup, state = _chaos_run(tmp_path, plan, "a", quorum=3)
    c = sup.summary()["counters"]
    assert c["degrade"] == 1 and "restore" not in c
    deg = [e for e in sup.events if e["event"] == "degrade"]
    assert deg[0]["attempt"] == 1 and deg[0]["backoff_s"] > 0
    sup2, _ = _chaos_run(tmp_path, plan, "b", quorum=3)
    assert [e.get("backoff_s") for e in sup2.events] == \
        [e.get("backoff_s") for e in sup.events]
    assert np.isfinite(_params(state)).all()
    _same_as_reference(sup, state,
                       *_reference_run(tmp_path, plan, "j", quorum=3))


def test_supervisor_retry_budget_and_non_oom(tmp_path):
    _, clock, step, state, batch_fn = _setup()
    calls = {"n": 0}

    def bad_step(st, batch):
        calls["n"] += 1
        raise RuntimeError("a kernel fault of the week")

    sup = Supervisor(clock, workers=M, ckpt_dir=str(tmp_path / "d"),
                     batch_size=8, retry_budget=2)
    with pytest.raises(RuntimeError, match="kernel fault"):
        sup.run(state, bad_step, batch_fn)
    assert calls["n"] == 3
    assert sup.summary()["counters"]["retry"] == 2
    assert "oom" not in sup.summary()["counters"]
    _, _, _, state2, _ = _setup()
    sup2 = Supervisor(clock, workers=M, batch_size=8)
    with pytest.raises(RuntimeError):
        sup2.run(state2, bad_step, batch_fn)
    assert sup2.events == []


def test_supervisor_oom_floor_propagates(tmp_path):
    _, clock, _, state, batch_fn = _setup()

    def oom_step(st, batch):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")

    sup = Supervisor(clock, workers=M, ckpt_dir=str(tmp_path / "d"),
                     batch_size=1)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        sup.run(state, oom_step, batch_fn)
    c = sup.summary()["counters"]
    assert c["oom"] == 1 and "shrink" not in c


def test_supervisor_validation():
    _, clock, _, _, _ = _setup()
    with pytest.raises(ValueError, match="workers"):
        Supervisor(clock, workers=0)
    with pytest.raises(ValueError, match="quorum"):
        Supervisor(clock, workers=M, quorum=-1)
    with pytest.raises(ValueError, match="exceeds the worker count"):
        Supervisor(clock, workers=M, quorum=M + 1)
    with pytest.raises(ValueError, match="retry_budget"):
        Supervisor(clock, workers=M, retry_budget=-1)
    with pytest.raises(ValueError, match="ckpt_every"):
        Supervisor(clock, workers=M, ckpt_every=0)
    with pytest.raises(ValueError, match="backoff_base"):
        Supervisor(clock, workers=M, backoff_base=0.0)
    with pytest.raises(ValueError, match="membership provider"):
        Supervisor(clock, workers=M,
                   membership=ScheduleMembership(M + 1, []))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

CHAOS_CMD = ["--arch", "yi-6b", "--smoke", "--d-model", "32", "--layers",
             "1", "--seq", "16", "--workers", "8", "--tau", "2", "--steps",
             "16", "--batch", "2", "--overlap", "staleness_k", "--staleness",
             "2", "--sharded", "--chaos",
             os.path.join(ROOT, "results", "chaos", "plan_ci.json"),
             "--quorum", "7", "--heartbeat-timeout", "0.9"]


def _supervisor_lines(text):
    ev = [l for l in text.splitlines() if l.startswith("supervisor events: ")]
    ct = [l for l in text.splitlines()
          if l.startswith("supervisor counters: ")]
    assert len(ev) == len(ct) == 1, text[-2000:]
    got = dict(kv.split("=") for kv in ct[0].split(": ", 1)[1].split())
    return ev[0].split(": ", 1)[1].split(), got


def test_chaos_ci_plan_pinned_sequence_8_ranks():
    """The committed CI plan through the port's launcher on 8 gloo ranks
    (sharded staleness_k, the rotation checkpoints written by rank 0 and
    restored on every rank): exactly the pinned recovery-event sequence,
    counters and final batch, printed by rank 0 alone."""
    with open(os.path.join(ROOT, "results", "chaos", "events_ci.json")) as f:
        pinned = json.load(f)
    out = td.spawn(td.launcher_runs, 8, [CHAOS_CMD], timeout=400)
    loss0, text0 = out[0][0]
    seq, counters = _supervisor_lines(text0)
    assert seq == pinned["event_seq"]
    assert int(counters.pop("final_batch")) == pinned["final_batch"]
    assert {k: int(v) for k, v in counters.items()} == pinned["counters"]
    assert "sharded round on mesh {'data': 8, 'model': 1}" in text0
    for (loss, text), in out[1:]:
        assert text == "" and loss == loss0
    assert np.isfinite(loss0)


def test_launcher_elastic_drop_quorum_events_match_reference():
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main
    argv = ["--arch", "yi-6b", "--smoke", "--workers", "4", "--tau", "2",
            "--steps", "8", "--seq", "16", "--batch", "2", "--overlap",
            "staleness_k", "--staleness", "1", "--elastic-drop", "2,1,3",
            "--quorum", "4"]
    outs = []
    for fn, kw in ((main, {"device": "cpu"}), (jmain, {})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(argv, **kw)
        outs.append(_supervisor_lines(buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0] == ["r1:degrade", "r2:degrade"]


@pytest.mark.parametrize("flags, msg", [
    (["--autotune", "--tau-schedule", "qsr"], "--tau-schedule qsr"),
    (["--tune-plan", "plan.json", "--qsr-beta", "0.5"], "pin a fixed tau"),
    (["--chaos", "p.json", "--elastic-drop", "1,0,2"], "mutually exclusive"),
    (["--quorum", "2"], "membership source"),
    (["--elastic-drop", "1,0,2"], "staleness_k"),
    (["--elastic-drop", "9,0,2"], "W,A,B"),
    (["--elastic-drop", "1,3,3"], "empty or negative"),
    (["--heartbeat-timeout", "0"], "heartbeat-timeout"),
    (["--retry-budget", "-1"], "retry-budget"),
    (["--quorum", "9"], "--quorum 9"),
])
def test_launcher_supervisor_flags(flags, msg, capsys):
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit):
        main(["--smoke", *flags], device="cpu")
    assert msg in capsys.readouterr().err
