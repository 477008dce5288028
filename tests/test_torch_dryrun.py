"""The dry-run planner, its census and its report.

* The CLI (``python -m repro_torch.launch.dryrun``) runs on the CPU and
  allocates nothing (a full-size gemma2-2b round, whose whole state is
  tens of GB and one rank's shard of it 11.8 GB, in a child process that
  stays under 3 GB), prints the
  reference's round-plan table first, writes records whose keys hold the
  reference's, and skips a record that exists.
* A ``VirtualMesh`` gives the same collectives (kinds, counts, bytes) as
  the port's mesh wrappers count in a real gloo run of the same MLP
  sharded rounds on the CPU: 1x2 and 2x1 on two ranks, 2,1,2 on four;
  ``none``, ``doublebuf`` and ``staleness_k`` (the ring).
* The kernel census: the trace's kernel calls equal the kernel wrappers'
  calls in the same round run on the CPU (the plain versions), for a
  flat-engine ``none`` round and a ``doublebuf`` round.
* The report reads the records, and the suite registry runs ``roofline``;
  only ``microbench`` still raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.train import RoundClock as JRoundClock
from repro_torch.benchmarks import roofline_report, run
from repro_torch.benchmarks.common import mlp_init, mlp_loss
from repro_torch.configs import DPPFConfig
from repro_torch.kernels.pullpush import pullpush as pk
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import analyze_step
from repro_torch.optim import make_optimizer
from repro_torch.train import RoundClock, init_train_state, make_round_step

import _torch_dist
from _torch_dist import _one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's record keys (repro/launch/dryrun.py:277-303, 312-318)
REF_KEYS = {"arch", "shape", "mesh", "mode", "plan", "chips", "tau",
            "overlap", "n_workers", "lower_s", "compile_s", "memory",
            "cost_raw_xla", "hlo_flops_per_dev", "hlo_bytes_per_dev",
            "collectives", "collective_axis_bytes", "roofline",
            "model_flops_total", "model_flops_per_chip_step",
            "useful_flop_ratio", "param_count", "active_param_count"}
REF_TRAIN_KEYS = {"overlap_model", "staleness"}
RSS_LIMIT = 3 << 30


# the child's own peak: VmHWM of its address space (``ru_maxrss`` would
# carry the forking test worker's resident size across the exec)
_CHILD = """
import runpy, sys
sys.argv = ["dryrun"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
hwm = [l for l in open("/proc/self/status") if l.startswith("VmHWM")]
print("MAXRSS", hwm[0].split()[1])
"""


def _cli(argv):
    """The CLI in a child process: (what it printed, its peak resident
    bytes)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD, *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    text, _, rss = out.stdout.rpartition("MAXRSS ")
    return text, int(rss) * 1024


def test_dry_run_cli(tmp_path):
    out_dir = str(tmp_path)
    argv = ["--arch", "gemma2-2b", "--shape", "train_4k", "--nodes", "1",
            "--tau", "1", "--out", out_dir]
    text, rss = _cli(argv)
    assert rss < RSS_LIMIT, rss
    table = JRoundClock(total_steps=dryrun.TRAIN_STEPS, tau=1,
                        base_lr=dryrun.TRAIN_LR, overlap="none",
                        staleness=1).plan_table()
    assert text.startswith(table + "\n\n")
    assert "[OK] gemma2-2b_train_4k_1n_train_baseline" in text
    assert text.rstrip().endswith("all dry-runs passed")
    train = json.load(open(os.path.join(
        out_dir, "gemma2-2b_train_4k_1n_train_baseline.json")))
    assert REF_KEYS | REF_TRAIN_KEYS <= set(train)
    assert {"engine", "kernels", "plan"} <= set(train)
    assert train["chips"] == 8 and train["n_workers"] == 1
    assert train["kernels"]["fused_round_sharded"]["calls"] == 1
    assert train["hlo_flops_per_dev"] > 0 and train["collectives"][
        "all-gather"]["bytes"] > 0
    mem = train["memory"]
    assert mem["argument_size_in_bytes"] > 10e9   # the rank's shard alone
    assert mem["temp_size_in_bytes"] > 0

    # in process: a decode record, then the cache
    buf = io.StringIO()
    dec = ["--arch", "gemma2-2b", "--shape", "decode_32k", "--nodes", "1",
           "--out", out_dir]
    with contextlib.redirect_stdout(buf):
        dryrun.main(dec)
    rec = json.load(open(os.path.join(
        out_dir, "gemma2-2b_decode_32k_1n_decode_baseline.json")))
    # one replica over the node's model axis of 8 cards takes all 128
    # sequences; gemma2-2b's 4 KV heads are each held by two ranks, so the
    # cache (~111 GB a card) does not fit
    assert REF_KEYS <= set(rec) and rec["fits"] is False
    assert rec["batch_per_replica"] == 128 and rec["replicas"] == 1
    assert rec["engine"] == "one replica over model = 8"
    assert sorted(rec["placed_apart"]) == [
        "blocks/stack/attn/wk", "blocks/stack/attn/wv", "k", "v"]
    stamp = {p: os.stat(os.path.join(out_dir, p)).st_mtime_ns
             for p in os.listdir(out_dir)}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main(dec)
        dryrun.main(argv)
    assert buf.getvalue().count("(cached)") == 2
    assert stamp == {p: os.stat(os.path.join(out_dir, p)).st_mtime_ns
                     for p in os.listdir(out_dir)}

    # the report and the registry over these records
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recs = run.suites(device="cpu", roofline_dir=out_dir)["roofline"]()
    lines = buf.getvalue().splitlines()
    assert len(recs) == 2
    assert sum(l.startswith("roofline,") for l in lines) == 2
    assert sum(l.startswith("roofline_overlap,") for l in lines) == 1
    assert sum(l.startswith("roofline_ring,") for l in lines) == 1
    assert roofline_report.load(out_dir) == recs
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run.suites(device="cpu")["microbench"]()


def test_dry_run_refuses_what_it_cannot_plan(tmp_path, capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "yi-6b", "--shape", "train_4k", "--nodes",
                     "2", "--plan", "hier", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[FAIL] yi-6b_train_4k_2n" in out and "multiple of 4" in out
    with pytest.raises(ValueError, match="train-mode"):
        dryrun.run_one("yi-6b", "decode_32k", 1, overlap="doublebuf",
                       out_dir=str(tmp_path))


@pytest.mark.parametrize("world, meshes", [(2, ("2x1", "1x2")),
                                           (4, ("2x1x2",))])
def test_virtual_mesh_counts_the_real_collectives(world, meshes):
    modes = ("none", "doublebuf", "staleness_k")
    res = _torch_dist.spawn(_torch_dist.traced_collectives, world, meshes,
                            modes)
    for rank, got in enumerate(res):
        assert len(got) == len(meshes) * len(modes)
        for key, rounds in got.items():
            for r, (real, virtual) in enumerate(rounds):
                assert real == virtual, (rank, key, r)
            kinds = {k for real, _ in rounds for k, v in real.items()
                     if v["count"]}
            assert "all-reduce" in kinds, (rank, key)
            if key.endswith("staleness_k") and not key.startswith("1x2"):
                assert "collective-permute" in kinds, (rank, key)


# ---------------------------------------------------------------------------
# the kernel census: trace against the CPU round's wrapper calls
# ---------------------------------------------------------------------------

WRAPPERS = ("fused_round", "fused_round_sharded", "partial_gram",
            "mix_from_gram", "mix_shard", "stale_mix", "gram_coef",
            "sq_dist", "apply_update")


def _launch_names(name, base):
    """The ``LAUNCHES`` names one call of wrapper ``name`` counts on the
    card."""
    mix = "stale_mix" if base else "mix_shard"
    return {"fused_round": ("fused_round", "partial_gram", mix),
            "fused_round_sharded": ("fused_round_sharded", "partial_gram",
                                    mix),
            "mix_from_gram": ("mix_from_gram", mix)}.get(name, (name,))


@pytest.mark.parametrize("overlap", ["none", "doublebuf"])
def test_the_trace_counts_the_kernels_the_round_calls(overlap, monkeypatch):
    M, tau, dim, ncls = 4, 3, 16, 4
    dcfg = DPPFConfig(alpha=0.2, lam=0.4, tau=tau, engine="flat",
                      overlap=overlap, overlap_chunks=2)
    opt = make_optimizer("sgd", momentum=0.9)
    clock = RoundClock.from_config(dcfg, base_lr=0.05, total_steps=40)
    gen = torch.Generator().manual_seed(0)
    p0 = mlp_init(gen, dim, ncls, width=8, device="cpu")
    runs = {}
    for device in ("cpu", "meta"):
        init = lambda g, dev: {l: {k: v.to(device) for k, v in d.items()}
                               for l, d in p0.items()}
        st = init_train_state(init, opt, dcfg, M, None, device=device)
        st.engine = dataclasses.replace(st.engine, use_kernel=True)
        step = make_round_step(mlp_loss, opt, dcfg, clock=clock)
        batch = {"x": torch.randn(tau, M, 8, dim, generator=gen),
                 "y": torch.randint(0, ncls, (tau, M, 8), generator=gen)}
        batch = {k: v.to(device) for k, v in batch.items()}
        if overlap != "none":          # the fill round, then a stale one
            st, _ = step(st, batch)
        runs[device] = (step, st, batch)

    calls = {}
    for name in WRAPPERS:
        fn = getattr(pk, name)

        def spy(*a, _name=name, _fn=fn, **kw):
            for launch in _launch_names(_name, kw.get("base") is not None):
                calls[launch] = calls.get(launch, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(pk, name, spy)
    step, st, batch = runs["cpu"]
    step(st, batch)
    assert calls, "the CPU round called no kernel wrapper"
    monkeypatch.undo()

    step, st, batch = runs["meta"]
    traced = analyze_step(step, st, batch)["kernels"]
    assert {k: v["calls"] for k, v in traced.items()} == calls
    for name, row in traced.items():
        assert row["bytes"] > 0 and row["flops"] > 0, name
