"""The port's method zoo and worker ablation against the reference's at
tiny budgets (see ``tests/test_torch_tables.py`` for the comparison)."""
from __future__ import annotations

import hashlib
import json
import pathlib

from test_torch_harness import (  # noqa: F401 (fixtures)
    carried, one_thread,
)
from test_torch_tables import (
    _both, one_seed, same_rows,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_method_zoo(carried, capsys):
    """Every registered method under label and speed skew, 8 steps, with
    its Mean Valley width; the committed ``results/method_zoo.json`` is
    not written (``out_json`` defaults to "")."""
    from benchmarks import table5_noniid as ref
    from repro_torch.benchmarks import table5_noniid as port
    zoo = ROOT / "results" / "method_zoo.json"
    before = hashlib.sha256(zoo.read_bytes()).hexdigest()
    got, want = _both(capsys, lambda: ref.run_zoo(steps=8, out_json=""),
                      lambda: port.run_zoo(steps=8, device="cpu"))
    assert len(want) == 9
    same_rows(got, want)
    assert hashlib.sha256(zoo.read_bytes()).hexdigest() == before


def test_method_zoo_writes_json_where_asked(carried, tmp_path, capsys):
    from repro_torch.benchmarks import table5_noniid as port
    path = tmp_path / "zoo" / "out.json"
    out = port.run_zoo(steps=4, out_json=str(path), device="cpu")
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert out["methods"]["ddp"]["mean_valley"] is None
    assert f"wrote {path}" in capsys.readouterr().out


def test_ablate_workers(carried, capsys, monkeypatch):
    from benchmarks import ablate_workers as ref
    from repro_torch.benchmarks import ablate_workers as port
    one_seed(monkeypatch, ref, port)
    got, want = _both(capsys, lambda: ref.run(steps=8),
                      lambda: port.run(steps=8, device="cpu"))
    same_rows(got, want)
