#!/usr/bin/env python3
"""Run the serving launcher drills of ``chip_smoke.py`` (phases 6(c), 8(c),
10(c) and 17(c): each config of ``DRILLS`` at full width and
``SERVE_LAYERS``' depth) for the source tree at ROOT (default: this
checkout), to compare a parent with a change on one card.

    python3 tools/serve_drills.py [ROOT [ARCH,ARCH,...]]

The drills are this checkout's (``chip_smoke._launcher_drill``); the
launcher, models and kernels are ROOT's (``ROOT/src`` first on the path).
A tree with the batched slot step (``repro_torch.serving.slot_step``) also
runs the card-side parity check and the one-forward-a-step assertions;
another tree is only measured. Prints the card's name and power limit,
then one JSON line a drill: ``{"root", "arch", "batched", "forwards_per_step",
"steps", "tok_s", "ttft_mean_ms", "decode_ms_per_step", ...}``. Run it on
two trees in turn (parent, change, change, parent), one process each; it
needs the card and imports nothing of JAX.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_MODULES = {"swa_attention": "swa_attention.swa_attention",
                  "ssd_chunks": "mamba_scan.mamba_scan",
                  "slstm_steps": "slstm_step.slstm_step"}


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("serve_drills: no CUDA device")
    root = os.path.abspath(argv[0] if argv else os.path.join(HERE, ".."))
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, os.path.join(HERE, ".."))
    import chip_smoke
    archs = argv[1].split(",") if len(argv) > 1 else list(chip_smoke.DRILLS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    from repro_torch import serving
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(*_build.all_sources())
    print(f"  {root}: kernels built in {time.perf_counter() - t0:.2f} s")
    mods = {name: importlib.import_module(f"repro_torch.kernels.{mod}")
            for name, mod in KERNEL_MODULES.items()}
    batched = hasattr(serving, "slot_step")
    for arch in archs:
        res = chip_smoke._launcher_drill(
            arch, {n: mods[n] for n in chip_smoke.DRILLS[arch][3]},
            batched=batched)
        res.pop("parity", None)
        print(json.dumps({"root": root, "arch": arch, "batched": batched}
                         | res))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
