"""The port's paper-table drivers (``repro_torch.benchmarks``) against the
reference's (``benchmarks/``) at tiny budgets on the CPU: the same CSV
names, the same keys in the same order, the same row labels, and numbers
close to the reference's, since the port's ``mlp_init`` is substituted by
one that returns the reference's weights (``mlp_params_from_numpy``) and
the first rounds of both trainers agree to 1e-5
(``tests/test_torch_harness.py``). Theorem 1's recurrence rows are equal.
The FL table, the method zoo, Table 3 and the worker ablation are in
``tests/test_torch_tables_fl.py`` and ``tests/test_torch_tables_zoo.py``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_harness import (  # noqa: F401 (fixtures)
    carried, one_thread,
)


def rows(text):
    """The CSV rows ``name,key=value,...`` of a driver's output, as
    ``(name, [(key, value), ...])`` with numbers as floats and
    ``True``/``False`` as bools."""
    out = []
    for line in text.splitlines():
        if line.startswith("#") or "=" not in line:
            continue
        name, *pairs = line.split(",")
        kv = []
        for p in pairs:
            k, v = p.split("=", 1)
            if v in ("True", "False"):
                v = v == "True"
            else:
                try:
                    v = float(v)
                except ValueError:
                    pass
            kv.append((k, v))
        out.append((name, kv))
    return out


# a number's tolerance by key: error points move by a few test samples
# (0.098 points each) when a weight crosses a ReLU kink at 1e-5, the rest
# are widths, norms and forces rounded to 3-4 digits
TOL = {"test_err": 0.5, "err_simplified": 0.5, "err_exact": 0.5,
       "std": 0.5, "dppf_best": 0.5, "baseline_best": 0.5,
       "dppf_sgd_vs_ddp_sgd": 1.0, "dppf_sam_vs_ddp_sam": 1.0}
# values that are functions of the compared numbers near a threshold
DERIVED = {"dppf_beats_baselines", "collapsing", "best", "best_lam",
           "xa_norm_monotone_up", "ratio_monotone_up", "push_wins_of_3",
           "dppf_wins_of_4", "t2_negligible", "kendall"}


def same_rows(got, want, exact=False):
    """Names, keys and labels equal; numbers within ``TOL`` (2e-3
    relative, 2e-3 absolute otherwise); ``DERIVED`` values only of the
    same type. ``exact``: every value equal."""
    assert [(n, [k for k, _ in kv]) for n, kv in got] == \
        [(n, [k for k, _ in kv]) for n, kv in want]
    for (name, gkv), (_, wkv) in zip(got, want):
        for (k, g), (_, w) in zip(gkv, wkv):
            what = f"{name} {k}: {g!r} vs {w!r}"
            if exact:
                assert g == w, what
            elif k in DERIVED:
                assert type(g) is type(w), what
            elif isinstance(w, float) and not isinstance(w, bool):
                assert isinstance(g, float), what
                tol = TOL.get(k, 2e-3 + 2e-3 * abs(w))
                assert abs(g - w) <= tol, what
            else:
                assert g == w, what


def one_seed(monkeypatch, *modules):
    """Both packages' drivers on their first seed only (a tiny budget;
    the std columns are then 0)."""
    for m in modules:
        monkeypatch.setattr(m, "SEEDS", m.SEEDS[:1])


def _both(capsys, ref_fn, port_fn):
    capsys.readouterr()
    ref_fn()
    want = rows(capsys.readouterr().out)
    port_fn()
    got = rows(capsys.readouterr().out)
    assert want, "the reference printed no rows"
    return got, want


def test_theorem1(carried, capsys):
    from benchmarks import theorem1_width as ref
    from repro_torch.benchmarks import theorem1_width as port
    got, want = _both(capsys, lambda: ref.run(steps=8),
                      lambda: port.run(steps=8, device="cpu"))
    rec = [r for r in want if r[0] == "theorem1_recurrence"]
    assert len(rec) == 4
    same_rows(got[:4], rec, exact=True)
    same_rows(got, want)


def test_fig2(carried, capsys):
    from benchmarks import fig2_valley_collapse as ref
    from repro_torch.benchmarks import fig2_valley_collapse as port
    got, want = _both(capsys, lambda: ref.run(steps=20),
                      lambda: port.run(steps=20, device="cpu"))
    assert [n for n, _ in want] == ["fig2"] * 5 + ["fig3"]
    same_rows(got, want)


def test_table2(carried, capsys, monkeypatch):
    from benchmarks import table2_comm as ref
    from repro_torch.benchmarks import table2_comm as port
    one_seed(monkeypatch, ref, port)
    got, want = _both(capsys, lambda: ref.run(steps=16),
                      lambda: port.run(steps=16, device="cpu"))
    assert len(want) == 10
    same_rows(got, want)


def test_table4(carried, capsys, monkeypatch):
    from benchmarks import table4_sam as ref
    from repro_torch.benchmarks import table4_sam as port
    one_seed(monkeypatch, ref, port)
    got, want = _both(capsys, lambda: ref.run(steps=8),
                      lambda: port.run(steps=8, device="cpu"))
    same_rows(got, want)


def test_ablate_schedule(carried, capsys, monkeypatch):
    from benchmarks import ablate_schedule as ref
    from repro_torch.benchmarks import ablate_schedule as port
    one_seed(monkeypatch, ref, port)
    got, want = _both(capsys, lambda: ref.run(steps=8),
                      lambda: port.run(steps=8, device="cpu"))
    same_rows(got, want)


def test_ablate_second_term(carried, capsys):
    from benchmarks import ablate_second_term as ref
    from repro_torch.benchmarks import ablate_second_term as port
    got, want = _both(capsys, lambda: ref.run(steps=8),
                      lambda: port.run(steps=8, device="cpu"))
    same_rows(got, want)


def test_d2_theorem2(carried, capsys):
    from benchmarks import d2_theorem2 as ref
    from repro_torch.benchmarks import d2_theorem2 as port
    got, want = _both(capsys, lambda: ref.run(steps=8),
                      lambda: port.run(steps=8, device="cpu"))
    same_rows(got, want)


# Table 1 on a reduced grid at one width, so that the reference compiles its
# measures for one shape: four combinations a mode; after 32 steps the
# first single-worker one stays above the drivers' 40% train error and is
# dropped
TABLE1_GRID = {"lr": [0.02, 0.1], "wd": [0.0], "bs": [16, 128],
               "width": [32]}
# each measure's tolerance, relative unless marked, as in
# tests/test_torch_measures.py: eps-sharpness is 100x a difference of two
# losses (absolute); the gaps are error points
TABLE1_TOL = {"eps_sharp": ("abs", 2e-5), "fisher_rao": ("rel", 1e-4),
              "lpf": ("rel", 1e-6), "lam_max": ("rel", 1e-4),
              "trace": ("rel", 1e-4), "frob": ("rel", 1e-4),
              "inv_mv": ("rel", 1e-5), "gap": ("abs", 0.0)}


class _Table1Draws:
    """The reference driver's random vectors, handed to the port's in the
    order it asks for them. Combination ``i`` gets a generator seeded with
    ``i`` where the reference uses ``key = PRNGKey(i)``; each measured
    combination draws LPF's 10 noise vectors (``fold_in(key, j)``), the
    Lanczos start (``key``), then 4 Rademacher vectors (``fold_in(key,
    1000 + j)``)."""

    def __init__(self):
        self.normals = self.signs = 0

    @staticmethod
    def _t(a, device):
        return torch.tensor(np.asarray(a)).to(device)

    def normal(self, gen, shape, device):
        key = jax.random.PRNGKey(gen.initial_seed())
        j, self.normals = self.normals % 11, self.normals + 1
        if j < 10:
            key = jax.random.fold_in(key, j)
        return self._t(jax.random.normal(key, tuple(shape)), device)

    def rademacher(self, gen, shape, device):
        j, self.signs = self.signs % 4, self.signs + 1
        key = jax.random.fold_in(jax.random.PRNGKey(gen.initial_seed()),
                                 1000 + j)
        return self._t(jax.random.rademacher(key, tuple(shape),
                                             dtype=jnp.float32), device)


def _taus_seen(monkeypatch, sharpness):
    """Record the inputs of every ``kendall_tau`` call: (measures, gaps)."""
    seen, tau = [], sharpness.kendall_tau

    def record(a, b):
        seen.append((list(a), list(b)))
        return tau(a, b)
    monkeypatch.setattr(sharpness, "kendall_tau", record)
    return seen


def _close(got, want, tol, what):
    kind, t = tol
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=t if kind == "rel" else 0,
                               atol=t if kind == "abs" else 0, err_msg=what)


def test_table1(carried, capsys, monkeypatch):
    """Both packages' Table 1 drivers on ``TABLE1_GRID``, 32 steps, with
    the reference's random vectors substituted for the port's draws: the
    same rows, and the inputs of every Kendall tau (each measure's values
    over the fitted combinations, and their generalization gaps) within
    ``TABLE1_TOL`` (the gaps equal: the same samples misclassified), so
    the printed taus are equal."""
    from benchmarks import table1_sharpness as ref
    from repro.core import sharpness as jsh
    from repro_torch.benchmarks import table1_sharpness as port
    from repro_torch.core import sharpness as sh
    for m in (ref, port):
        monkeypatch.setattr(m, "GRID", TABLE1_GRID)
    draws = _Table1Draws()
    monkeypatch.setattr(sh, "_normal", draws.normal)
    monkeypatch.setattr(sh, "_rademacher", draws.rademacher)
    want_in, got_in = _taus_seen(monkeypatch, jsh), _taus_seen(monkeypatch,
                                                                sh)
    got, want = _both(capsys, lambda: ref.run(steps=32),
                      lambda: port.run(steps=32, device="cpu"))
    same_rows(got, want)
    named = [(d["mode"], d["measure"]) for d in map(dict, (kv for _, kv
                                                           in want))
             if d["kendall"] != "NA"]
    assert len(named) == len(want_in) == len(got_in) == 13
    fitted = {mode: len(wg) for (mode, _), (_, wg) in zip(named, want_in)}
    assert fitted == {"single": 3, "easgd": 4}
    for (mode, name), (g, gg), (w, wg) in zip(named, got_in, want_in):
        _close(gg, wg, TABLE1_TOL["gap"], f"{mode} gaps")
        _close(g, w, TABLE1_TOL[name], f"{mode} {name}")
    for (_, gkv), (_, wkv) in zip(got, want):
        g, w = dict(gkv)["kendall"], dict(wkv)["kendall"]
        assert g == w, (dict(wkv), g)
