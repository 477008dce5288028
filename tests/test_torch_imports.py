"""Every module of the port imports without JAX and without the JAX
package, and the port's entry points default to the card."""
from __future__ import annotations

import dataclasses
import inspect
import os
import pathlib
import subprocess
import sys

from repro_torch.core.engine import ConsensusEngine
from repro_torch.data.synthetic import classification_task

ROOT = pathlib.Path(__file__).resolve().parents[1]

_WALK = """
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    """A fresh interpreter imports every module of ``repro_torch`` (found
    by ``pkgutil.walk_packages``); neither ``jax`` nor ``repro`` ends up in
    ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _WALK], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.strip().splitlines()[-1])
    expected = {".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert n == len(expected) - 1      # all but the package's own __init__


def test_entry_points_default_to_the_card():
    fields = {f.name: f.default for f in dataclasses.fields(ConsensusEngine)}
    assert fields["device"] == "cuda"
    sig = inspect.signature(classification_task)
    assert sig.parameters["device"].default == "cuda"
    data = classification_task(n_train=16, n_test=8, device="cpu")
    assert data["x_train"].device.type == "cpu"


def test_fault_tolerance_modules_are_walked_and_launchers_use_the_card():
    """The checkpoint, chaos, supervisor and OOM-contract modules are among
    the walked ones; both launchers default to the card; ``chip_smoke.py``
    imports neither JAX nor the JAX package."""
    import ast

    from repro_torch.launch import serve, train
    for rel in ("checkpoint/__init__.py", "checkpoint/io.py",
                "train/chaos.py", "train/supervisor.py",
                "train/autotune.py", "launch/mesh.py"):
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    for mod in (train, serve):
        assert inspect.signature(mod.main).parameters["device"].default \
            == "cuda"
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, bad


def test_model_family_modules_are_walked():
    """The MoE and enc-dec modules are among the walked ones, and each
    imports alone in a fresh interpreter without JAX or the JAX
    package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for rel in ("models/moe.py", "models/encdec.py"):
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    code = ("import sys; import repro_torch.models.moe, "
            "repro_torch.models.encdec; bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_autotune_and_roofline_import_alone():
    """``launch/roofline.py`` and the full ``train/autotune.py`` (the
    search, the plan, the probe runners) import alone in a fresh
    interpreter without JAX or the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for rel in ("launch/roofline.py", "train/autotune.py"):
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    code = ("import sys, importlib; "
            "rf = importlib.import_module('repro_torch.launch.roofline'); "
            "at = importlib.import_module('repro_torch.train.autotune'); "
            "names = ('PLAN_VERSION', 'Candidate', 'TuneSpace', "
            "'ProbeResult', 'TunePlan', 'per_sample_us', 'autotune', "
            "'inject_oom_above', 'make_round_probe_runner', "
            "'make_lm_model_fn', 'is_oom', 'OOM_TOKENS'); "
            "assert all(hasattr(at, n) for n in names); "
            "assert all(hasattr(rf, n) for n in ('roofline', "
            "'overlap_model', 'probe_round_model', 'reconcile_probes', "
            "'model_flops', 'serving_model', 'supervisor_model')); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_launch_analysis_modules_import_alone():
    """The launch-analysis modules (``launch/specs.py``, ``validate.py``,
    ``dryrun.py``, ``census.py`` and ``benchmarks/roofline_report.py``)
    are among the walked ones and import alone in a fresh interpreter
    without JAX or the JAX package; importing the dry-run runs nothing."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    mods = ("launch/specs.py", "launch/validate.py", "launch/dryrun.py",
            "launch/census.py", "benchmarks/roofline_report.py")
    for rel in mods:
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    names = ", ".join("repro_torch." + m[:-3].replace("/", ".")
                      for m in mods)
    code = (f"import sys; import {names}; "
            "from repro_torch.launch import roofline as rf; "
            "assert all(hasattr(rf, n) for n in ('analyze_step', "
            "'collective_bytes')); "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == ""
