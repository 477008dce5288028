"""Benchmark harness — one module per paper table/figure. Prints CSV lines
``name,key=value,...`` per row. ``--fast`` shrinks budgets for CI.

Counterpart of the reference's ``benchmarks/run.py``; the suites run on
the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast] \
      [--only table2,...] [--device cuda|cpu]

``microbench`` is not ported yet: it raises, so a run that includes it
exits non-zero (leave it out with ``--only``). ``roofline`` reads the
dry-run records of ``repro_torch.launch.dryrun`` (``results/dryrun_torch``
unless ``suites(roofline_dir=...)`` names another directory).
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

# Paper-artifact registry: one row per suite — (paper artifact, script,
# what it reproduces); the reference's rows, with this package's scripts.
ARTIFACTS = {
    "microbench": (
        "—", "benchmarks/microbench.py",
        "hot-path microbenches (not yet ported)"),
    "theorem1": (
        "Thm. 1", "repro_torch/benchmarks/theorem1_width.py",
        "asymptotic valley width -> lambda/alpha on the proof recurrence "
        "and on real DNN training"),
    "fig2": (
        "Fig. 2-3", "repro_torch/benchmarks/fig2_valley_collapse.py",
        "valley collapse without the push force; pull/push tug-of-war"),
    "table1": (
        "Table 1", "repro_torch/benchmarks/table1_sharpness.py",
        "Kendall rank correlation of sharpness measures vs generalization "
        "gap"),
    "table2": (
        "Table 2 / Fig. 1", "repro_torch/benchmarks/table2_comm.py",
        "communication volume vs test error: DDP / LocalSGD / QSR / DPPF"),
    "table3": (
        "Table 3", "repro_torch/benchmarks/table3_softconsensus.py",
        "soft-consensus optimizers with/without the push (incl. Remark 1: "
        "LSGD push-from-leader vs push-from-average)"),
    "table4": (
        "Table 4", "repro_torch/benchmarks/table4_sam.py",
        "local vs distributed flatness: DDP/DPPF x SGD/SAM grid"),
    "table5": (
        "Table 5", "repro_torch/benchmarks/table5_noniid.py",
        "non-IID FL: SCAFFOLD / FedLESAM with and without DPPF "
        "aggregation"),
    "method_zoo": (
        "§2 related methods", "repro_torch/benchmarks/table5_noniid.py",
        "heterogeneous-worker zoo: every registered consensus method "
        "(core.methods) under Dirichlet label skew + speed skew, with "
        "Mean Valley width per method"),
    "ablate_schedule": (
        "§C.2 + §7.2", "repro_torch/benchmarks/ablate_schedule.py",
        "lambda-schedule ablation (fixed/increasing/decreasing) plus the "
        "increasing+qsr round-clock row: QSR-adaptive tau on the best "
        "schedule, reporting comm volume next to error"),
    "ablate_second_term": (
        "§D.1 / Fig. 7", "repro_torch/benchmarks/ablate_second_term.py",
        "is the dropped second push term T2 negligible?"),
    "d2_theorem2": (
        "§D.2 / Thm. 2", "repro_torch/benchmarks/d2_theorem2.py",
        "sensitivity of test error to lambda; Theorem 2's assumptions"),
    "ablate_workers": (
        "Tables 3-4 (M axis)", "repro_torch/benchmarks/ablate_workers.py",
        "worker-count scaling of the push edge and width M-robustness"),
    "roofline": (
        "—", "repro_torch/benchmarks/roofline_report.py",
        "per-(arch x shape x H100 node count) roofline from the dry-run "
        "records"),
}

NOT_PORTED = "not yet ported"


def _not_ported(name):
    def fn():
        raise NotImplementedError(f"{name}: {NOT_PORTED}")
    return fn


def suites(fast=False, device="cuda", roofline_dir=None):
    """``{name: callable}`` in the reference's order, with its budgets
    (``fast``: the reference's ``--fast`` ones). ``roofline_dir``: where
    the ``roofline`` row reads its dry-run records."""
    from repro_torch.benchmarks import (
        ablate_schedule, ablate_second_term, ablate_workers, d2_theorem2,
        fig2_valley_collapse, roofline_report, table1_sharpness,
        table2_comm, table3_softconsensus, table4_sam, table5_noniid,
        theorem1_width,
    )
    from repro_torch.launch.dryrun import OUT
    d = dict(device=device)
    return {
        "microbench": _not_ported("microbench"),
        "theorem1": lambda: theorem1_width.run(steps=200 if fast else 600,
                                               **d),
        "fig2": lambda: fig2_valley_collapse.run(steps=200 if fast else 600,
                                                 **d),
        "table2": lambda: table2_comm.run(steps=150 if fast else 400, **d),
        "table3": lambda: table3_softconsensus.run(
            steps=150 if fast else 400, **d),
        "table4": lambda: table4_sam.run(steps=150 if fast else 400, **d),
        "table5": lambda: table5_noniid.run(rounds=8 if fast else 25, **d),
        "method_zoo": lambda: table5_noniid.run_zoo(
            steps=80 if fast else 240, **d),
        "ablate_schedule": lambda: ablate_schedule.run(
            steps=150 if fast else 400, **d),
        "ablate_second_term": lambda: ablate_second_term.run(
            steps=150 if fast else 400, **d),
        "d2_theorem2": lambda: d2_theorem2.run(steps=150 if fast else 400,
                                               **d),
        "ablate_workers": lambda: ablate_workers.run(
            steps=150 if fast else 400, **d),
        "table1": lambda: table1_sharpness.run(steps=120 if fast else 300,
                                               **d),
        "roofline": lambda: roofline_report.run(roofline_dir or OUT),
    }


def main(argv=None):
    """Runs the chosen suites; returns ``{suite: seconds}`` of those that
    finished, and exits with status 1 if any failed."""
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.run")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("repro_torch.benchmarks.run: no CUDA device "
                             "(pass --device cpu to run on the CPU)")
    table = suites(args.fast, args.device)
    if set(table) != set(ARTIFACTS):
        raise SystemExit("ARTIFACTS registry out of sync with suites: "
                         f"{sorted(set(table) ^ set(ARTIFACTS))}")
    only = [s for s in args.only.split(",") if s]
    unknown = sorted(set(only) - set(table))
    if unknown:
        raise SystemExit(f"unknown suites: {unknown}")
    failures, seconds = [], {}
    for name, fn in table.items():
        if only and name not in only:
            continue
        t0 = time.time()
        print(f"# === {name} ===", flush=True)
        try:
            fn()
            seconds[name] = time.time() - t0
            print(f"# {name} done in {seconds[name]:.1f}s", flush=True)
        except Exception as e:
            failures.append(name)
            print(f"# {name} FAILED: {e!r}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"# FAILURES: {failures}")
        sys.exit(1)
    print("# all benchmarks completed")
    return seconds


if __name__ == "__main__":
    main()
