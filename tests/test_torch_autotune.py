"""The port's autotune search (``repro_torch.train.autotune``) against the
reference's (``repro.train.autotune``).

The probe runner is the only part of the search that touches a device, so
``tests/_faults.py::scripted_runner`` (a scripted feasibility frontier whose
failures carry ``RESOURCE_EXHAUSTED``) drives both packages' ``autotune``
with the same ``model_fn``: the ``TunePlan`` JSON must be byte-identical in
every case of the search (no OOM, the frontier at 12 of the reference's
``BENCH_autotune.json``, a hole in the ladder, a spent budget, chunks
beyond tau, the modes without chunks) and over random frontiers and
budgets. A plan that either package writes loads in the other and re-dumps
byte for byte, and replays to the same round plan. On the CPU the port's
real round probe runner times reduced yi-6b, ``inject_oom_above`` drives
its backoff, and the launcher's ``--autotune`` / ``--tune-plan`` choose
what the reference's launcher chooses under equal roofline constants."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import os

import numpy as np
import pytest
import torch

from _faults import default_time_fn, noisy_time_fn, scripted_runner
from _hyp import given, settings, st

import repro.launch.roofline as jrf
import repro_torch.launch.roofline as rf
from repro.configs import DPPFConfig as JDPPFConfig
from repro.train import RoundClock as JRoundClock
from repro_torch.configs import DPPFConfig
from repro_torch.train import (
    Candidate, RoundClock, Supervisor, TunePlan, TuneSpace, autotune,
    inject_oom_above, make_lm_model_fn, make_round_probe_runner,
)

# the modules (each package's ``train`` re-exports a function of the name)
at = importlib.import_module("repro_torch.train.autotune")
jat = importlib.import_module("repro.train.autotune")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space_kw(**kw):
    out = dict(min_batch=1, max_batch=32, taus=(2, 4), chunks=(1, 2),
               probe_budget=16)
    out.update(kw)
    return out


def _both(*, fail_above=None, fail_batches=(), time_fn=None,
          model_fn=default_time_fn, **kw):
    """The port's and the reference's plans for one scripted frontier, the
    same runner and model; plus each package's log of the probes run."""
    plans, logs = [], []
    for pkg in (at, jat):
        log = []
        runner = scripted_runner(fail_above=fail_above,
                                 fail_batches=fail_batches,
                                 time_fn=time_fn, log=log)
        plans.append(pkg.autotune(runner, model_fn,
                                  pkg.TuneSpace(**_space_kw(**kw))))
        logs.append([(c.batch, c.tau, c.overlap_chunks) for c in log])
    return plans, logs


SEARCH_CASES = {
    "no_oom": dict(max_batch=32),
    "bench_frontier_12": dict(fail_above=12, min_batch=2, max_batch=32,
                              taus=(2, 4), chunks=(1, 2), probe_budget=16,
                              overlap="doublebuf"),
    "hole_at_8": dict(fail_batches={8}),
    "budget_spent": dict(max_batch=64, probe_budget=3),
    "budget_mid_refine": dict(fail_above=13, probe_budget=6),
    "chunks_beyond_tau": dict(max_batch=4, taus=(2,), chunks=(1, 4)),
    "no_chunks_none": dict(fail_above=9, overlap="none", chunks=(1, 2, 4)),
    "no_chunks_staleness1": dict(fail_above=9, overlap="staleness1",
                                 chunks=(1, 2, 4)),
    "staleness_k_2": dict(fail_above=20, overlap="staleness_k",
                          staleness=2, taus=(4, 8), chunks=(1, 2, 4)),
    "noisy_timer": dict(fail_above=11,
                        time_fn=noisy_time_fn(default_time_fn, noise=0.2,
                                              seed=3)),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_plan_json_is_byte_identical_to_the_reference(case):
    (plan, jplan), (log, jlog) = _both(**SEARCH_CASES[case])
    assert plan.dumps() == jplan.dumps()
    assert log == jlog
    assert plan.probes_used <= plan.probe_budget
    assert list(plan.failures) == sorted(set(plan.failures))


def test_search_cases_exercise_what_they_name():
    (p, _), _ = _both(**SEARCH_CASES["bench_frontier_12"])
    assert p.chosen.batch == 12 and p.failures == (13, 14, 16)
    (p, _), _ = _both(**SEARCH_CASES["hole_at_8"])
    assert p.chosen.batch == 7 and 8 in p.failures
    (p, _), _ = _both(**SEARCH_CASES["budget_spent"])
    assert p.probes_used == 3 and p.chosen == Candidate(4, 2, 1)
    (_, _), (log, _) = _both(**SEARCH_CASES["chunks_beyond_tau"])
    assert all(c <= t for _, t, c in log) and (4, 2, 4) not in log
    for case in ("no_chunks_none", "no_chunks_staleness1"):
        (p, _), (log, _) = _both(**SEARCH_CASES[case])
        assert {c for _, _, c in log} == {1}
    (p, _), _ = _both(**SEARCH_CASES["no_oom"])
    assert p.chosen.batch == 32 and p.failures == ()


def test_lm_model_fn_plans_match_under_equal_constants(monkeypatch):
    """Each package's own ``make_lm_model_fn`` as the model: with the
    port's constants set to the reference's the plans are byte-identical;
    on the H100's they keep the frontier and the probe ladder."""
    kw = dict(n_params=1_216_385_024, seq=2048, workers=4,
              overlap="doublebuf")
    space = _space_kw(fail_above=5, max_batch=8, taus=(4, 8),
                      chunks=(1, 2, 4), overlap="doublebuf")
    fail = space.pop("fail_above")
    h100 = at.autotune(scripted_runner(fail_above=fail),
                       make_lm_model_fn(**kw), TuneSpace(**space))
    monkeypatch.setattr(rf, "PEAK_FLOPS", jrf.PEAK_FLOPS)
    monkeypatch.setattr(rf, "LINK_BW", jrf.ICI_BW)
    plan = at.autotune(scripted_runner(fail_above=fail),
                       make_lm_model_fn(**kw), TuneSpace(**space))
    jplan = jat.autotune(scripted_runner(fail_above=fail),
                         jat.make_lm_model_fn(**kw), jat.TuneSpace(**space))
    assert plan.dumps() == jplan.dumps()
    assert [(p.batch, p.tau, p.overlap_chunks, p.ok) for p in h100.probes] \
        == [(p.batch, p.tau, p.overlap_chunks, p.ok) for p in plan.probes]
    assert h100.failures == plan.failures


@settings(max_examples=30, deadline=None)
@given(frontier=st.integers(min_value=1, max_value=64),
       budget=st.integers(min_value=1, max_value=24),
       max_batch=st.integers(min_value=1, max_value=48))
def test_prop_plans_equal_the_reference(frontier, budget, max_batch):
    (plan, jplan), (log, jlog) = _both(fail_above=frontier,
                                       max_batch=max_batch,
                                       probe_budget=budget)
    assert plan.dumps() == jplan.dumps()
    assert log == jlog
    assert plan.probes_used <= budget
    assert plan.chosen.batch <= min(frontier, max_batch)


def test_min_batch_oom_and_real_bugs_behave_alike():
    for pkg in (at, jat):
        with pytest.raises(ValueError, match="no feasible batch"):
            pkg.autotune(scripted_runner(fail_batches={1}), default_time_fn,
                         pkg.TuneSpace(**_space_kw()))

        def broken(cand):
            raise ZeroDivisionError("a real bug, not memory pressure")
        with pytest.raises(ZeroDivisionError):
            pkg.autotune(broken, default_time_fn,
                         pkg.TuneSpace(**_space_kw(max_batch=4)))


def test_space_guards_match_the_reference():
    bad = (dict(probe_budget=0), dict(min_batch=0), dict(min_batch=9,
           max_batch=8), dict(taus=()), dict(taus=(0,)), dict(chunks=()),
           dict(chunks=(2, 0)), dict(overlap="bogus"), dict(staleness=0))
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            jat.TuneSpace(**kw)
        with pytest.raises(ValueError) as err:
            TuneSpace(**kw)
        assert str(err.value) == str(jerr.value)
    for mode in ("none", "staleness1", "doublebuf", "staleness_k"):
        assert TuneSpace(overlap=mode, chunks=(1, 2)).chunk_ladder() == \
            jat.TuneSpace(overlap=mode, chunks=(1, 2)).chunk_ladder()


def test_injection_fires_before_the_device():
    seen = []
    runner = inject_oom_above(lambda c: seen.append(c) or 7.0, 4)
    jrunner = jat.inject_oom_above(lambda c: 7.0, 4)
    assert runner(Candidate(4, 2, 1)) == 7.0
    for r in (runner, jrunner):
        with pytest.raises(RuntimeError) as e:
            r(Candidate(5, 2, 1))
        assert at.is_oom(e.value) and jat.is_oom(e.value)
    assert len(seen) == 1
    with pytest.raises(ValueError):
        inject_oom_above(lambda c: 1.0, 0)


# ---------------------------------------------------------------------------
# plans across packages
# ---------------------------------------------------------------------------

def test_plans_cross_load_and_redump_byte_for_byte(tmp_path):
    (plan, jplan), _ = _both(**SEARCH_CASES["bench_frontier_12"])
    plan.save(str(tmp_path / "port.json"))
    jplan.save(str(tmp_path / "ref.json"))
    port_text = (tmp_path / "port.json").read_text()
    assert port_text == (tmp_path / "ref.json").read_text()
    assert jat.TunePlan.load(str(tmp_path / "port.json")).dumps() == \
        port_text
    assert TunePlan.load(str(tmp_path / "ref.json")).dumps() == port_text
    # the reference's committed plan loads in the port
    with open(os.path.join(ROOT, "BENCH_autotune.json")) as f:
        committed = json.load(f)["autotune"]["plan"]
    assert TunePlan.from_dict(committed).dumps() == \
        jat.TunePlan.from_dict(committed).dumps()


def test_plan_guards_match_the_reference():
    (plan, _), _ = _both(fail_above=5)
    d = plan.to_dict()
    d["version"] = 99
    for cls in (TunePlan, jat.TunePlan):
        with pytest.raises(ValueError, match="version"):
            cls.from_dict(d)
        with pytest.raises(ValueError, match="malformed TunePlan"):
            cls.from_dict({"chosen": {"batch": 2}})
    with pytest.raises(ValueError, match="probe_budget"):
        dataclasses.replace(plan, probe_budget=0)
    with pytest.raises(ValueError, match="overlap"):
        dataclasses.replace(plan, overlap="bogus")
    with pytest.raises(ValueError, match="chosen"):
        dataclasses.replace(plan, chosen=Candidate(0, 2, 1))


def _rounds(clock):
    return [(s.index, s.start, s.tau) for s in clock.rounds]


@pytest.mark.parametrize("overlap,k", [("doublebuf", 1), ("staleness_k", 2),
                                       ("none", 1)])
def test_clock_from_tune_plan_equal_in_both_packages(overlap, k):
    (plan, jplan), _ = _both(fail_above=13, overlap=overlap, staleness=k)
    kw = dict(base_lr=0.3, total_steps=37, warmup=8 if k > 1 else 0)
    dcfg = DPPFConfig(alpha=0.2, lam=0.4, engine="flat",
                      consensus="entropy_sgd")
    jdcfg = JDPPFConfig(alpha=0.2, lam=0.4, engine="flat",
                        consensus="entropy_sgd")
    bare = RoundClock.from_tune_plan(plan, **kw)
    assert RoundClock.from_tune_plan(plan.to_dict(), **kw) == bare
    assert _rounds(bare) == _rounds(JRoundClock.from_tune_plan(jplan, **kw))
    assert bare.describe() == JRoundClock.from_tune_plan(
        jplan.to_dict(), **kw).describe()
    with_cfg = RoundClock.from_tune_plan(plan, dcfg=dcfg, **kw)
    assert with_cfg == RoundClock.from_config(dcfg.apply_tune_plan(plan),
                                              **kw)
    assert RoundClock.from_tune_plan(plan.to_dict(), dcfg=dcfg,
                                     **kw) == with_cfg
    j_with = JRoundClock.from_tune_plan(jplan, dcfg=jdcfg, **kw)
    assert _rounds(with_cfg) == _rounds(j_with)
    assert with_cfg.describe() == j_with.describe()
    assert with_cfg.inner_rounds == j_with.inner_rounds > 1
    # the port's plan replays in the reference, the reference's in the port
    assert _rounds(RoundClock.from_tune_plan(jplan, **kw)) == \
        _rounds(JRoundClock.from_tune_plan(plan, **kw))


def test_supervisor_shrinks_down_the_plan_ladder():
    """The OOM shrink ladder: the plan's feasible batches below the
    current one, else halving, as the reference's supervisor."""
    from repro.train import Supervisor as JSupervisor
    (plan, jplan), _ = _both(fail_above=13)
    clock = RoundClock(total_steps=8, tau=2, base_lr=0.1)
    jclock = JRoundClock(total_steps=8, tau=2, base_lr=0.1)
    for bs in (13, 12, 8, 4, 3, 1, 20):
        got = Supervisor(clock, workers=2, tune_plan=plan,
                         batch_size=bs)._shrunk_batch()
        want = JSupervisor(jclock, workers=2, tune_plan=jplan,
                           batch_size=bs)._shrunk_batch()
        assert got == want
        assert Supervisor(clock, workers=2, batch_size=bs)._shrunk_batch() \
            == JSupervisor(jclock, workers=2,
                           batch_size=bs)._shrunk_batch()


# ---------------------------------------------------------------------------
# the real probe runner and the launcher, on the CPU
# ---------------------------------------------------------------------------

def _smoke_yi():
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    cfg = reduced(get_arch("yi-6b"), d_model=32, head_dim=32, d_ff=64,
                  n_layers=1)
    model = build_model(cfg)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=16)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    return cfg, model, task, opt, make_round_batch


def test_real_probe_runner_times_rounds_and_backs_off():
    cfg, model, task, opt, make_round_batch = _smoke_yi()
    M = 4
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=2, engine="flat",
                      overlap="doublebuf", overlap_chunks=1)
    runner = make_round_probe_runner(
        model.init, model.loss, opt, dcfg, M,
        lambda c: make_round_batch(task, 0, M, c.tau, 0, c.batch, cfg,
                                   device="cpu"),
        base_lr=0.1, total_steps=8, reps=1, device="cpu")
    assert runner(Candidate(2, 2, 2)) > 0
    n = sum(v.numel() for v in torch.utils._pytree.tree_leaves(
        model.init(torch.Generator().manual_seed(0), "cpu")))
    plan = autotune(inject_oom_above(runner, 3),
                    make_lm_model_fn(n_params=n, seq=16, workers=M,
                                     overlap="doublebuf"),
                    TuneSpace(min_batch=1, max_batch=8, taus=(2,),
                              chunks=(1, 2), probe_budget=8))
    assert plan.chosen.batch == 3             # 1, 2, 4 (OOM), 3
    assert plan.failures == (4,)
    assert [(p.batch, p.ok) for p in plan.probes][:4] == [
        (1, True), (2, True), (4, False), (3, True)]
    assert all(p.us_round > 0 for p in plan.probes if p.ok)
    assert "RESOURCE_EXHAUSTED" in plan.probes[2].error


def test_runner_reports_an_oom_without_its_frames():
    """An allocator OOM inside a probe comes back as a fresh exception of
    the same kind with the same message, and no traceback into the probe
    (whose fleet would otherwise stay reachable)."""
    cfg, model, task, opt, make_round_batch = _smoke_yi()
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=2, engine="flat")

    def batch_fn(c):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.93 GiB")
    runner = make_round_probe_runner(model.init, model.loss, opt, dcfg, 2,
                                     batch_fn, device="cpu")
    with pytest.raises(torch.cuda.OutOfMemoryError) as e:
        runner(Candidate(1, 2, 1))
    assert str(e.value) == "CUDA out of memory. Tried to allocate 2.93 GiB"
    assert at.is_oom(e.value)
    frames = []
    tb = e.value.__traceback__
    while tb is not None:
        frames.append(tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    assert "probe" not in frames and "batch_fn" not in frames

    def bug(c):
        raise KeyError("a real bug")
    runner = make_round_probe_runner(model.init, model.loss, opt, dcfg, 2,
                                     bug, device="cpu")
    with pytest.raises(KeyError):
        runner(Candidate(1, 2, 1))


LAUNCH = ["--arch", "yi-6b", "--smoke", "--d-model", "32", "--layers", "1",
          "--workers", "4", "--tau", "2", "--steps", "8", "--seq", "16",
          "--batch", "1", "--overlap", "doublebuf", "--probe-budget", "6"]


def _ladder(plan):
    return ([(p["batch"], p["tau"], p["overlap_chunks"], p["ok"])
             for p in plan["probes"]], plan["failures"], plan["chosen"])


def test_launcher_autotune_chooses_what_the_reference_chooses(
        tmp_path, monkeypatch):
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main
    monkeypatch.setattr(rf, "PEAK_FLOPS", jrf.PEAK_FLOPS)
    monkeypatch.setattr(rf, "HBM_BW", jrf.HBM_BW)
    monkeypatch.setattr(rf, "LINK_BW", jrf.ICI_BW)
    flags = ["--autotune", "--tune-oom-above", "3", "--tune-plan"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loss = main(LAUNCH + flags + [str(tmp_path / "p.json")],
                    device="cpu")
        jmain(LAUNCH + flags + [str(tmp_path / "j.json")])
    assert np.isfinite(loss)
    plan = json.loads((tmp_path / "p.json").read_text())
    jplan = json.loads((tmp_path / "j.json").read_text())
    assert _ladder(plan) == _ladder(jplan)
    assert plan["chosen"]["batch"] == 3 and plan["failures"] == [4]
    assert [p["modeled_us"] for p in plan["probes"]] == \
        [p["modeled_us"] for p in jplan["probes"]]
    lines = out.getvalue().splitlines()
    assert sum(line.startswith("autotune: chose batch=3 tau=")
               for line in lines) == 2
    assert sum(line.startswith("tune plan -> ") for line in lines) == 2


def test_launcher_replay_equals_the_chosen_flags_by_hand(tmp_path):
    from repro_torch.launch.train import main
    plan_path = str(tmp_path / "p.json")
    with contextlib.redirect_stdout(io.StringIO()):
        main(LAUNCH + ["--autotune", "--tune-oom-above", "3",
                       "--tune-plan", plan_path], device="cpu")
    ch = json.loads(open(plan_path).read())["chosen"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        replay = main(LAUNCH + ["--tune-plan", plan_path, "--ckpt",
                                str(tmp_path / "replay.npz")], device="cpu")
        hand = LAUNCH[:LAUNCH.index("--tau")] + [
            "--tau", str(ch["tau"]), "--steps", "8", "--seq", "16",
            "--batch", str(ch["batch"]), "--overlap", "doublebuf",
            "--overlap-chunks", str(ch["overlap_chunks"])]
        by_hand = main(hand + ["--ckpt", str(tmp_path / "hand.npz")],
                       device="cpu")
    assert f"tune plan <- {plan_path}: batch={ch['batch']} " \
           f"tau={ch['tau']} chunks={ch['overlap_chunks']}" in out.getvalue()
    assert replay == by_hand
    with np.load(str(tmp_path / "replay.npz")) as za, \
            np.load(str(tmp_path / "hand.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files) and za.files
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), k


REFUSALS = (
    ["--autotune", "--tau-schedule", "qsr", "--qsr-beta", "0.5"],
    ["--tune-plan", "p.json", "--qsr-beta", "0.5"],
    ["--autotune", "--method", "ddp"],
)


@pytest.mark.parametrize("extra", REFUSALS, ids=["qsr", "qsr_beta", "ddp"])
def test_launcher_refusals_match_the_reference(extra):
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main
    msgs = []
    for fn in (lambda a: main(a, device="cpu"), jmain):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
            fn(["--arch", "yi-6b", "--smoke"] + extra)
        assert e.value.code == 2
        msgs.append(err.getvalue().strip().splitlines()[-1].split(
            "error: ", 1)[1])
    assert msgs[0] == msgs[1]
