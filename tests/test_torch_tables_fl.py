"""The port's FL table and Table 3 against the reference's at tiny
budgets (see ``tests/test_torch_tables.py`` for the comparison), and
``repro_torch.benchmarks.run``: the reference's suites, artifacts and
``--fast`` budgets, the suites not ported yet, and a CPU run of one
suite."""
from __future__ import annotations

import sys

import pytest

from test_torch_harness import (  # noqa: F401 (fixtures)
    carried, one_thread,
)
from test_torch_tables import (
    _both, one_seed, rows, same_rows,
)


def test_table3(carried, capsys, monkeypatch):
    from benchmarks import table3_softconsensus as ref
    from repro_torch.benchmarks import table3_softconsensus as port
    one_seed(monkeypatch, ref, port)
    got, want = _both(capsys, lambda: ref.run(steps=8),
                      lambda: port.run(steps=8, device="cpu"))
    assert len(want) == 9
    same_rows(got, want)


def test_table5(carried, capsys, monkeypatch):
    """SCAFFOLD / FedLESAM with and without the DPPF aggregation, one
    round of 16 local steps per (Dirichlet alpha, method)."""
    from benchmarks import table5_noniid as ref
    from repro_torch.benchmarks import table5_noniid as port
    one_seed(monkeypatch, ref, port)
    got, want = _both(capsys, lambda: ref.run(rounds=1),
                      lambda: port.run(rounds=1, device="cpu"))
    assert len(want) == 9
    same_rows(got, want)


# ---------------------------------------------------------------------------
# run.py
# ---------------------------------------------------------------------------

DRIVERS = {  # suite -> (module, function) in both packages
    "theorem1": ("theorem1_width", "run"),
    "fig2": ("fig2_valley_collapse", "run"),
    "table1": ("table1_sharpness", "run"),
    "table2": ("table2_comm", "run"),
    "table3": ("table3_softconsensus", "run"),
    "table4": ("table4_sam", "run"),
    "table5": ("table5_noniid", "run"),
    "method_zoo": ("table5_noniid", "run_zoo"),
    "ablate_schedule": ("ablate_schedule", "run"),
    "ablate_second_term": ("ablate_second_term", "run"),
    "d2_theorem2": ("d2_theorem2", "run"),
    "ablate_workers": ("ablate_workers", "run"),
}


def _record(monkeypatch, package, calls):
    import importlib
    for suite, (mod, fn) in DRIVERS.items():
        m = importlib.import_module(f"{package}.{mod}")
        monkeypatch.setattr(m, fn, lambda _s=suite, **kw:
                            calls.setdefault(_s, kw))


@pytest.mark.parametrize("fast", [False, True])
def test_run_calls_the_reference_suites_with_its_budgets(monkeypatch, fast):
    """Both ``run.main``s with every driver stubbed: the same suites in
    the same order with the same budgets (the port adds ``device``, and
    its zoo writes no JSON unless asked)."""
    import benchmarks.run as jrun
    from repro_torch.benchmarks import run
    want, got = {}, {}
    _record(monkeypatch, "benchmarks", want)
    _record(monkeypatch, "repro_torch.benchmarks", got)
    only = ",".join(DRIVERS)
    monkeypatch.setattr(sys, "argv", ["run"] + ["--fast"] * fast
                        + ["--only", only])
    jrun.main()
    run.main(["--only", only, "--device", "cpu"] + ["--fast"] * fast)
    assert list(got) == list(want)
    for suite, kw in want.items():
        kw = {k: v for k, v in kw.items() if k != "out_json"}
        assert got[suite] == dict(kw, device="cpu"), suite
    assert set(run.ARTIFACTS) == set(jrun.ARTIFACTS)
    assert set(run.suites()) == set(run.ARTIFACTS)


@pytest.mark.parametrize("suite", ["microbench", "roofline"])
def test_run_refuses_the_suites_not_ported(suite, capsys):
    from repro_torch.benchmarks import run
    with pytest.raises(SystemExit) as e:
        run.main(["--only", suite, "--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "not yet ported" in out and f"# FAILURES: ['{suite}']" in out


def test_run_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch
    from repro_torch.benchmarks import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        run.main(["--fast", "--only", "theorem1"])
    with pytest.raises(SystemExit, match="unknown suites"):
        run.main(["--only", "table9", "--device", "cpu"])


def test_run_fast_theorem1_on_the_cpu(capsys):
    """``python -m repro_torch.benchmarks.run --fast --only theorem1
    --device cpu``: its seven rows, every number finite, the recurrence
    within Theorem 1's finite-M margin and the trained width within 10%
    of lam / alpha."""
    from repro_torch.benchmarks import run
    secs = run.main(["--fast", "--only", "theorem1", "--device", "cpu"])
    assert list(secs) == ["theorem1"]
    got = rows(capsys.readouterr().out)
    assert [n for n, _ in got] == ["theorem1_recurrence"] * 4 \
        + ["theorem1_training"] * 3
    for _, kv in got:
        d = dict(kv)
        assert all(v == v and abs(v) < float("inf") for v in d.values())
        assert d["rel_err"] < 0.1
