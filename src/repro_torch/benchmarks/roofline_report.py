"""The roofline tables from the port's dry-run records (counterpart of the
reference's ``benchmarks/roofline_report.py``). It reads only; run the
dry-run first:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --nodes 1,32
  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report

Three row kinds, one CSV line each: ``roofline`` (a record's compute,
memory and collective seconds on H100 constants, its bottleneck, flops
and collective bytes a card), ``roofline_overlap`` (a train record's
modelled exact / staleness1 / doublebuf / staleness-k rounds and the
comm/compute crossover, ``launch.roofline.overlap_model``) and
``roofline_ring`` (the staleness-k ring's bytes a hop against the
gather's). It reads ``results/dryrun_torch/`` (or ``out_dir``), never the
reference's TPU records under ``results/dryrun/``.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.benchmarks.common import csv
from repro_torch.launch.dryrun import OUT


def load(out_dir=OUT):
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def run(out_dir=OUT):
    recs = load(out_dir)
    if not recs:
        csv("roofline", status="no dry-run records found; run "
            "repro_torch.launch.dryrun")
        return []
    for r in recs:
        t = r["roofline"]
        coll = sum(v["bytes"] for v in r["collectives"].values())
        csv("roofline",
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"], mode=r["mode"],
            plan=r["plan"], overlap=r.get("overlap", "none"),
            compute_s=f"{t['compute_s']:.3e}",
            memory_s=f"{t['memory_s']:.3e}",
            collective_s=f"{t['collective_s']:.3e}",
            bottleneck=t["bottleneck"].replace("_s", ""),
            flops_dev=f"{r['hlo_flops_per_dev']:.3e}",
            coll_bytes_dev=f"{coll:.3e}",
            useful_flop_ratio=round(r.get("useful_flop_ratio", 0.0), 3),
            trace_s=r["lower_s"])
    for r in recs:
        om = r.get("overlap_model")
        if not om or r.get("overlap", "none") != "none":
            continue
        ks = om.get("staleness_k_s", {})
        csv("roofline_overlap",
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"], plan=r["plan"],
            exact_s=f"{om['exact_s']:.3e}",
            staleness1_s=f"{om['staleness1_s']:.3e}",
            doublebuf_s=f"{om['doublebuf_s']:.3e}",
            stalek1_s=f"{ks['1']:.3e}" if "1" in ks else "-",
            stalek2_s=f"{ks['2']:.3e}" if "2" in ks else "-",
            stalek4_s=f"{ks['4']:.3e}" if "4" in ks else "-",
            crossover=round(om["crossover"], 3),
            overlap_gain=round(om["overlap_gain"], 3),
            note="crossover<1: doublebuf hides ALL consensus comm behind "
                 "the tau local steps; staleness-k widens the window "
                 "k-fold")
    for r in recs:
        om = r.get("overlap_model")
        if not om or "ring_bytes_per_hop" not in om \
                or r.get("overlap", "none") != "none":
            continue
        csv("roofline_ring",
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"], plan=r["plan"],
            gather_bytes=f"{om['gather_bytes']:.3e}",
            ring_bytes_per_hop=f"{om['ring_bytes_per_hop']:.3e}",
            ring_hops=om["ring_hops"],
            ring_s=f"{om['ring_s']:.3e}")
    return recs


if __name__ == "__main__":
    run()
