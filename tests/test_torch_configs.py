"""The port's copy of the configs equals the reference field for field, and
neither the port nor chip_smoke.py imports JAX or the JAX package."""
from __future__ import annotations

import ast
import dataclasses
import pathlib

import pytest

import repro.configs as jconfigs
import repro_torch.configs as pconfigs

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def test_arch_registry_is_the_same_set():
    assert sorted(pconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    assert len(pconfigs.ARCHS) == 10


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_config_and_reduced_equal_the_reference(name):
    a, b = pconfigs.get_arch(name), jconfigs.get_arch(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(pconfigs.reduced(a)) \
        == dataclasses.asdict(jconfigs.reduced(b))
    assert a.param_count() == b.param_count()


def test_dppf_config_and_shapes_equal_the_reference():
    assert dataclasses.asdict(pconfigs.DPPFConfig()) \
        == dataclasses.asdict(jconfigs.DPPFConfig())
    kw = dict(alpha=0.2, lam=0.8, tau=3, consensus="easgd", engine="flat")
    assert dataclasses.asdict(pconfigs.DPPFConfig(**kw)) \
        == dataclasses.asdict(jconfigs.DPPFConfig(**kw))
    assert {k: dataclasses.asdict(v) for k, v in
            pconfigs.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in
            jconfigs.INPUT_SHAPES.items()}
    with pytest.raises(ValueError):
        pconfigs.DPPFConfig(consensus="lpf_sgd")      # flat-only method


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return tree, names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists()
    tree, names = _imports(path)
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                          ast.Name):
            assert node.value.id not in ("jax", "jnp"), (path, node.attr)
