"""``--autotune`` with ``--sharded`` / ``--mesh`` on two gloo ranks on the
CPU: rank 0 alone probes (the reference's search on the single-device
round with the whole fleet), broadcasts the plan's JSON, and both ranks
hold it byte for byte (the sha256 each rank prints equals that of the
``--tune-plan`` file rank 0 alone writes) and train at its point on the
sharded round; rank 1 probes nothing."""
from __future__ import annotations

import hashlib
import json
import os
import re

import _torch_dist
from _torch_dist import _one_torch_thread  # noqa: F401  (autouse)

FLAGS = ["--arch", "yi-6b", "--smoke", "--d-model", "32", "--layers", "1",
         "--workers", "4", "--tau", "2", "--steps", "8", "--seq", "16",
         "--batch", "1", "--max-batch", "4", "--probe-budget", "4",
         "--tune-oom-above", "2", "--overlap", "doublebuf", "--autotune"]
LINE = re.compile(r"autotune rank (\d): plan sha256 ([0-9a-f]{64}), probes "
                  r"here (\d+)")


def test_rank0_searches_and_every_rank_replays_its_plan(tmp_path):
    meshes = (["--sharded"], ["--mesh", "2,1,1"])
    plans = [str(tmp_path / f"plan{i}.json") for i in range(len(meshes))]
    res = _torch_dist.spawn(_torch_dist.launcher_runs, 2, [
        FLAGS + m + ["--tune-plan", p] for m, p in zip(meshes, plans)])
    assert sorted(os.listdir(tmp_path)) == ["plan0.json", "plan1.json"]
    got = []
    for i, path in enumerate(plans):
        text = open(path).read()
        plan = json.loads(text)
        seen = {}
        for rank in (0, 1):
            loss, out = res[rank][i]
            (line,) = LINE.findall(out)
            seen[int(line[0])] = (line[1], int(line[2]))
            assert loss == loss                       # a finite eval loss
        # both ranks hold rank 0's JSON byte for byte; rank 1 probed none
        assert seen[0][0] == seen[1][0] \
            == hashlib.sha256(text.encode()).hexdigest()
        assert seen[0][1] == plan["probes_used"] > 0
        assert seen[1][1] == 0
        ch = plan["chosen"]
        out0, out1 = res[0][i][1], res[1][i][1]
        assert (f"autotune: chose batch={ch['batch']} tau={ch['tau']} "
                f"chunks={ch['overlap_chunks']}") in out0
        assert "sharded round on mesh" in out0
        assert "autotune: chose" not in out1
        got.append(plan["failures"])
    # the scripted frontier on either mesh
    assert got == [[3, 4], [3, 4]]
